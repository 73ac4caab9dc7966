"""The GELU-MLP forwards' host plan (kernels 7 and 2 on csrc/gemm_sm90.cuh's
TMA/wgmma tile product, csrc/mlp.cu and csrc/ln_mlp.cu), checked through
faked launches on the CPU: everything the C side is handed is decided in
ops/ffn.py.

- Each product's rank-2 tensor maps: A (K, M) and B (K, N) dims, the row
  pitch in bytes and the (64, rows) box, with 128-byte swizzle; the grids
  and the tile widths at ViT's (4160, 1024) / hidden 2048 (kernel 7) and
  the ViTVQGAN main path's (8192, 512) / hidden 1368 (kernel 2); the
  shared memory within the H100's 232,448 bytes a block.
- g's and W2's rows start 64-byte aligned (hidden 1368: a pitch of 1376
  elements), and the first product writes g at the pitch the second reads;
  W2 is staged at that pitch by the C side at every call, from the weight
  itself: a write through ``.data`` reaches the next call.
- The plan cache; every gated ln_mlp width and a hidden width that is not
  a multiple of 8 reaching a launch with the padded width; the biases
  passed in their own dtype (bf16 or fp32); views TMA cannot take refused
  by name before any launch.
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

SMEM_LIMIT = 232448


def _fake_launches(monkeypatch):
    """The kernel path without a card: each launch records its name and
    arguments."""
    launched = []
    monkeypatch.setattr(t_ffn, "is_kernel_path", lambda t: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "launch",
                        lambda name, *a: launched.append((name, a)))
    return launched


# where each C entry takes the plan, and (n, d, hid) after it
PLAN_ARG = {"amt_mlp": 9, "amt_ln_mlp": 11}
# where each takes W2 and its stage
W2_ARG = {"amt_mlp": (3, 7), "amt_ln_mlp": (5, 10)}


def _decode(arr):
    """The 42 plan values the C side reads, by product and name (both
    operands K-major, K never split)."""
    v = list(arr)
    assert len(v) == 42
    out = {}
    for name, p in (("up", v[:21]), ("down", v[21:])):
        assert (p[5], p[11], p[15]) == (0, 0, 1)  # majorness, one K range
        assert p[20] == -(-p[0] // 64)            # every K slice
        out[name] = dict(a=dict(dims=tuple(p[0:2]), stride=p[2],
                                box=tuple(p[3:5])),
                         b=dict(dims=tuple(p[6:8]), stride=p[8],
                                box=tuple(p[9:11])),
                         swizzle=p[12], grid=tuple(p[13:15]), threads=p[16],
                         smem=p[17], bn=p[18], ldc=p[19])
    return out


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def _mlp(n, d, hid):
    with torch.no_grad():
        t_ffn.fused_mlp(_bf16(n, d), _bf16(hid, d), torch.zeros(hid),
                        _bf16(d, hid), torch.zeros(d))


def _ln_mlp(n, d, hid):
    with torch.no_grad():
        t_ffn.fused_ln_mlp(_bf16(n, d), torch.ones(d), torch.zeros(d),
                           _bf16(hid, d), torch.zeros(hid), _bf16(d, hid),
                           torch.zeros(d))


def _one_launch(launched):
    ((name, args),) = launched
    i = PLAN_ARG[name]
    return name, _decode(args[i]), args[i + 1:i + 4], args


def test_kernel_7_plan_at_vits_shape(monkeypatch):
    launched = _fake_launches(monkeypatch)
    _mlp(4160, 1024, 2048)
    name, plan, nd, args = _one_launch(launched)
    assert name == "amt_mlp" and nd == (4160, 1024, 2048)
    assert args[5] is None  # no residual
    up, down = plan["up"], plan["down"]
    assert up["a"] == dict(dims=(1024, 4160), stride=2048, box=(64, 128))
    assert up["b"] == dict(dims=(1024, 2048), stride=2048, box=(64, 128))
    assert (up["grid"], up["bn"], up["ldc"]) == ((16, 33), 128, 2048)
    assert down["a"] == dict(dims=(2048, 4160), stride=4096, box=(64, 128))
    assert down["b"] == dict(dims=(2048, 1024), stride=4096, box=(64, 256))
    assert (down["grid"], down["bn"], down["ldc"]) == ((4, 33), 256, 1024)
    for p in (up, down):
        assert (p["swizzle"], p["threads"]) == (128, 288)
        assert p["smem"] <= SMEM_LIMIT


def test_kernel_2_plan_at_the_main_paths_shape(monkeypatch):
    launched = _fake_launches(monkeypatch)
    _ln_mlp(8192, 512, 1368)
    name, plan, nd, args = _one_launch(launched)
    assert name == "amt_ln_mlp" and nd == (8192, 512, 1368)
    up, down = plan["up"], plan["down"]
    # the first product reads the LayerNorm's Y (8192, 512) and W1
    assert up["a"] == dict(dims=(512, 8192), stride=1024, box=(64, 128))
    assert up["b"] == dict(dims=(512, 1368), stride=1024, box=(64, 128))
    assert (up["grid"], up["bn"]) == ((11, 64), 128)
    # g and W2: K 1368 at a 1376-element (2752-byte) pitch
    assert up["ldc"] == 1376
    assert down["a"] == dict(dims=(1368, 8192), stride=2752, box=(64, 128))
    assert down["b"] == dict(dims=(1368, 512), stride=2752, box=(64, 256))
    assert (down["grid"], down["bn"], down["ldc"]) == ((2, 64), 256, 512)
    for p in (up, down):
        assert (p["swizzle"], p["threads"]) == (128, 288)
        assert p["smem"] <= SMEM_LIMIT


def test_shared_memory_of_each_tile_width():
    # stages x (A 128 x 64 + B BN x 64) bf16, a full and an empty mbarrier a
    # stage, 1024 bytes of alignment slack; two BN 128 blocks fit an SM
    assert t_gemm.gemm_smem_bytes(128) == 3 * 256 * 128 + 48 + 1024 == 99376
    assert t_gemm.gemm_smem_bytes(256) == 4 * 384 * 128 + 64 + 1024 == 197696
    assert 2 * (t_gemm.gemm_smem_bytes(128) + 1024) <= 233472
    assert t_gemm.gemm_smem_bytes(256) <= SMEM_LIMIT


@pytest.mark.parametrize("n,gelu,bn", [(2048, True, 128), (1368, True, 128),
                                       (1024, False, 256), (512, False, 256),
                                       (128, False, 128), (96, True, 128)])
def test_tile_width_rule(n, gelu, bn):
    assert t_ffn.pick_bn(n, gelu) == bn


def _rows_at(ptr: int, rows: int, k: int, pitch: int) -> torch.Tensor:
    """The bf16 bits of a (rows, k) matrix at host address ``ptr``,
    ``pitch`` elements a row: what the C side reads there."""
    buf = (ctypes.c_int16 * (rows * pitch)).from_address(ptr)
    return torch.frombuffer(buf, dtype=torch.int16).view(rows, pitch)[:, :k]


@pytest.mark.parametrize("k,pitch", [(1368, 1376), (2048, 2048), (96, 96),
                                     (104, 128), (2728, 2752)])
def test_aligned_rows(monkeypatch, k, pitch):
    """W2 (d, k) reaches the C side as it is, with a stage of 64-byte
    aligned rows where k is not a multiple of 32; the second product's B
    map reads rows ``pitch`` elements apart."""
    launched = _fake_launches(monkeypatch)
    w2 = torch.arange(128 * k, dtype=torch.float32).reshape(128, k).bfloat16()
    with torch.no_grad():
        t_ffn.fused_mlp(_bf16(16, 128), _bf16(k, 128), torch.zeros(k), w2,
                        torch.zeros(128))
    name, plan, _, args = _one_launch(launched)
    w2_at, stage_at = W2_ARG[name]
    assert args[w2_at] == w2.data_ptr()
    assert plan["down"]["b"]["stride"] == 2 * pitch
    assert (args[stage_at] is None) == (pitch == k)
    if pitch != k:
        assert args[stage_at] % 64 == 0
    assert t_ffn.row_pitch(k) == pitch


def test_the_aligned_copy_is_held_until_the_weight_changes(monkeypatch):
    """No copy of W2 is held between calls any more: each call hands the C
    side the weight itself (hidden 104: staged at a pitch of 128), so a
    repeated call, an in-place update and an inference-mode weight all
    reach the kernels as they are at that call."""
    launched = _fake_launches(monkeypatch)
    w = torch.arange(128 * 104, dtype=torch.float32).reshape(128, 104)
    w = w.bfloat16()

    def call(w2):
        t_ffn.fused_mlp(_bf16(16, 128), _bf16(104, 128), torch.zeros(104),
                        w2, torch.zeros(128))
        name, plan, _, args = _one_launch(launched[-1:])
        assert plan["down"]["b"]["stride"] == 2 * 128
        ptr, stage = args[W2_ARG[name][0]], args[W2_ARG[name][1]]
        assert ptr == w2.data_ptr() and stage is not None
        return _rows_at(ptr, 128, 104, 104)

    with torch.no_grad():
        assert torch.equal(call(w), call(w))
        w.add_(1)  # an in-place update: the next call reads the new values
        assert torch.equal(call(w), w.view(torch.int16))
    with torch.inference_mode():  # no version to key on: nothing is keyed
        wi = w.clone()
        assert torch.equal(call(wi), wi.view(torch.int16))


@pytest.mark.parametrize("entry", ["amt_mlp", "amt_ln_mlp"])
def test_a_write_through_data_reaches_the_kernels(monkeypatch, entry):
    """A write through ``w2.data`` (which bumps neither the version nor the
    pointer) reaches the next call: the C side reads the weight it is
    given, at its own pitch, and stages it itself."""
    launched = _fake_launches(monkeypatch)
    d, hid = 128, 1368
    w2 = torch.randn(d, hid, generator=torch.Generator().manual_seed(0))
    w2 = w2.bfloat16()
    args = (_bf16(16, d), _bf16(hid, d), torch.zeros(hid), w2,
            torch.zeros(d))
    for _ in range(3):
        with torch.no_grad():
            if entry == "amt_mlp":
                t_ffn.fused_mlp(*args)
            else:
                t_ffn.fused_ln_mlp(args[0], torch.ones(d), torch.zeros(d),
                                   *args[1:])
        name, plan, _, a = _one_launch(launched[-1:])
        w2_at, stage_at = W2_ARG[name]
        assert a[stage_at] is not None
        assert plan["down"]["b"]["stride"] == 2 * 1376
        assert torch.equal(_rows_at(a[w2_at], d, hid, hid),
                           w2.view(torch.int16))
        w2.data.mul_(2)


def test_the_plan_is_cached(monkeypatch):
    x, w1, w2 = _bf16(64, 256), _bf16(96, 256), _bf16(256, 96)
    assert t_ffn.mlp_plan(x, w1, w2) is t_ffn.mlp_plan(x, w1, w2)
    launched = _fake_launches(monkeypatch)
    _mlp(64, 256, 96)
    _mlp(64, 256, 96)
    (_, a1), (_, a2) = launched
    assert a1[9] is a2[9]  # the same C array, built once


@pytest.mark.parametrize("d", [128, 256, 384, 512, 768, 1024])
@pytest.mark.parametrize("hid", [1368, 100])
def test_every_gated_width_launches_with_the_padded_hidden_width(
        monkeypatch, d, hid):
    launched = _fake_launches(monkeypatch)
    _ln_mlp(16, d, hid)
    name, plan, nd, args = _one_launch(launched)
    hp = -(-hid // 8) * 8  # 100 -> 104: 16-byte rows
    pitch = -(-hp // 32) * 32
    assert name == "amt_ln_mlp" and nd == (16, d, hp)
    assert args[8] is not None and args[9] is not None  # Y and g scratches
    assert plan["up"]["b"]["dims"] == (d, hp)
    assert plan["up"]["ldc"] == pitch
    assert plan["down"]["a"]["dims"] == (hp, 16)
    assert plan["down"]["b"]["dims"] == (hp, d)
    assert plan["down"]["a"]["stride"] == 2 * pitch
    assert plan["down"]["b"]["stride"] == 2 * pitch
    assert plan["down"]["bn"] == (128 if d <= 128 else 256)
    assert plan["down"]["grid"] == (-(-d // plan["down"]["bn"]), 1)


@pytest.mark.parametrize("entry", ["amt_mlp", "amt_ln_mlp"])
@pytest.mark.parametrize("b1_dt,b2_dt,code", [
    (torch.bfloat16, torch.bfloat16, 1), (torch.float32, torch.float32, 0),
    (torch.bfloat16, torch.float32, 0)])
def test_the_biases_reach_the_kernel_in_their_dtype(monkeypatch, entry,
                                                    b1_dt, b2_dt, code):
    """bf16 biases are read as bf16 by the epilogues, uncast; a mixed pair
    goes as fp32."""
    launched = _fake_launches(monkeypatch)
    b1, b2 = torch.zeros(96, dtype=b1_dt), torch.zeros(128, dtype=b2_dt)
    args = (_bf16(16, 128), _bf16(96, 128), b1, _bf16(128, 96), b2)
    with torch.no_grad():
        if entry == "amt_mlp":
            t_ffn.fused_mlp(*args)
        else:
            t_ffn.fused_ln_mlp(args[0], torch.ones(128), torch.zeros(128),
                               *args[1:])
    ((name, a),) = launched
    i = PLAN_ARG[name]
    assert name == entry and a[-2] == code
    b_args = (a[2], a[4]) if entry == "amt_mlp" else (a[4], a[6])
    # only a bf16 bias beside an fp32 one is cast (to a new tensor)
    cast = (b1_dt != b2_dt, False)
    assert [p != t.data_ptr() for p, t in zip(b_args, (b1, b2))] == [*cast]
    assert len(a) == i + 6 + (entry == "amt_ln_mlp")


def _misaligned(*shape):
    """A bf16 tensor of ``shape`` whose storage starts 2 bytes past a
    16-byte boundary."""
    n = 1
    for s in shape:
        n *= s
    return _bf16(n + 8)[1:n + 1].view(*shape)


@pytest.mark.parametrize("which", ["x", "w1", "w2"])
def test_a_misaligned_operand_is_refused_by_name_unlaunched(monkeypatch,
                                                            which):
    launched = _fake_launches(monkeypatch)
    ops = dict(x=_bf16(16, 128), w1=_bf16(96, 128), w2=_bf16(128, 96))
    ops[which] = _misaligned(*ops[which].shape)
    with pytest.raises(ValueError, match=f"{which} starts at an address"):
        with torch.no_grad():
            t_ffn.fused_mlp(ops["x"], ops["w1"], torch.zeros(96), ops["w2"],
                            torch.zeros(128))
    assert launched == []


def test_views_tma_cannot_take_are_refused_by_the_plan():
    x, w1 = _bf16(16, 128), _bf16(96, 128)
    # a row pitch of 200 bytes (not a multiple of 16)
    with pytest.raises(ValueError, match="w2's row stride of 200 bytes"):
        t_ffn.mlp_plan(x, w1, _bf16(128, 100)[:, :96])
    # a transposed view: its last dimension is not contiguous
    with pytest.raises(ValueError, match="w1 needs a contiguous last"):
        t_ffn.mlp_plan(x, _bf16(128, 96).t(), _bf16(128, 96))
    with pytest.raises(ValueError, match="x starts at an address"):
        t_ffn.mlp_plan(_misaligned(16, 128), w1, _bf16(128, 96))


def test_a_non_contiguous_input_is_refused_unlaunched(monkeypatch):
    launched = _fake_launches(monkeypatch)
    with pytest.raises(ValueError, match="x: must be contiguous"):
        with torch.no_grad():
            t_ffn.fused_ln_mlp(_bf16(128, 32).t(), torch.ones(128),
                               torch.zeros(128), _bf16(96, 128),
                               torch.zeros(96), _bf16(128, 96),
                               torch.zeros(128))
    assert launched == []
