"""The bf16 flash backward's host plan (kernels 5, 10, 17 and 18 on the
wgmma/TMA dkv and dq kernels of csrc/flash_attention_bwd.cu), checked
through faked launches on the CPU: everything the C side is handed is
decided in ops/flash_attention.py.

- Each operand's rank-4 tensor map (q, k, v and dout), (d, t, h, b) dims,
  byte strides of t, h and b taken from the view, and the (d, 64) box, for
  the three layouts (packed kv's k and v views included), at head width 32
  and 64; the swizzle is one tile row (64 or 128 bytes).
- The dkv grid (b*h, k tiles of 64) and the dq grid (b*h, q tiles of 64) at
  ragged lengths and at causal tq < tk; causal dq tiles run heaviest first.
- Each kernel's dynamic shared memory: two dkv or four dq blocks fit an SM.
- The plan cache, fp32 without a plan, and views TMA cannot take refused by
  name before any launch; kernel 10's wrapper makes a broadcast cotangent
  contiguous.
The expected values are written out from the layouts, not from the plan
code.
"""

import contextlib

import pytest
import torch

from attention_models_torch.ops import _build
from attention_models_torch.ops import flash_attention as t_flash


def _fake_launches(monkeypatch):
    """The kernel path without a card: each launch records its name and
    arguments."""
    launched = []
    monkeypatch.setattr(t_flash, "is_kernel_path", lambda t: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "launch",
                        lambda name, *a: launched.append((name, a)))
    return launched


# where each C entry takes the plan (ops/_build.py's signatures)
PLAN_ARG = {"amt_flash_bwd_kv": 7, "amt_flash_bwd_dkv": 9,
            "amt_flash_bwd_dq": 8}


def _decode(arr):
    """The 45 plan values the C side reads, by name."""
    v = list(arr)
    assert len(v) == 45
    maps = {n: dict(dims=tuple(v[9 * i:9 * i + 4]),
                    strides=tuple(v[9 * i + 4:9 * i + 7]),
                    box=tuple(v[9 * i + 7:9 * i + 9]))
            for i, n in enumerate(("q", "k", "v", "dout"))}
    return dict(maps=maps, swizzle=v[36], dkv_grid=tuple(v[37:39]),
                dq_grid=tuple(v[39:41]), threads=v[41], dkv_smem=v[42],
                dq_smem=v[43], dq_heaviest_first=v[44])


def _plans_of(launched):
    return [(name, _decode(args[PLAN_ARG[name]])) for name, args in launched]


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def _run(layout, b, h, tq, tk, d, causal, dtype=torch.bfloat16):
    """One backward through the wrapper(s) of ``layout``."""
    z = lambda *s: torch.zeros(*s, dtype=dtype)  # noqa: E731
    f = lambda *s: torch.zeros(*s)  # noqa: E731
    if layout == "kv":
        q = z(b, tq, h, d)
        t_flash.flash_attention_bwd_kv(q, z(b, tk, 2, h, d), q, f(b, tq, h),
                                       q, scale=0.1, causal=causal)
    elif layout == "bthd":
        q, k = z(b, tq, h, d), z(b, tk, h, d)
        t_flash.flash_attention_bwd_bthd(q, k, k, q, f(b, tq, h), q,
                                         scale=0.1, causal=causal)
    else:
        q, k, lse = z(b, h, tq, d), z(b, h, tk, d), f(b, h, tq)
        t_flash.flash_bwd_dkv(q, q, lse, lse, k, k, scale=0.1, causal=causal)
        t_flash.flash_bwd_dq(k, k, q, q, lse, lse, scale=0.1, causal=causal)


def _bthd_strides(t, h, d):
    """Byte steps of t, h and b in a contiguous (b, t, h, d) bf16 tensor."""
    return (h * d * 2, d * 2, t * h * d * 2)


def _heads_strides(t, h, d):
    """Byte steps of t, h and b in a contiguous (b, h, t, d) bf16 tensor."""
    return (d * 2, t * d * 2, h * t * d * 2)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("layout", ["kv", "bthd", "heads"])
def test_tensor_maps_follow_each_layout(monkeypatch, layout, d):
    launched = _fake_launches(monkeypatch)
    b, h, tq, tk = 2, 3, 256, 384
    _run(layout, b, h, tq, tk, d, False)
    plans = _plans_of(launched)
    want_entries = {"kv": ["amt_flash_bwd_kv"],
                    "bthd": ["amt_flash_bwd_dkv", "amt_flash_bwd_dq"],
                    "heads": ["amt_flash_bwd_dkv", "amt_flash_bwd_dq"]}
    assert [n for n, _ in plans] == want_entries[layout]
    for _, plan in plans:
        q, k, v, g = (plan["maps"][n] for n in ("q", "k", "v", "dout"))
        assert q["dims"] == g["dims"] == (d, tq, h, b)
        assert k["dims"] == v["dims"] == (d, tk, h, b)
        if layout == "heads":
            assert q["strides"] == g["strides"] == _heads_strides(tq, h, d)
            assert k["strides"] == v["strides"] == _heads_strides(tk, h, d)
        elif layout == "bthd":
            assert q["strides"] == g["strides"] == _bthd_strides(tq, h, d)
            assert k["strides"] == v["strides"] == _bthd_strides(tk, h, d)
        else:  # k and v step over both halves of a packed (b, t, 2, h, d) row
            assert q["strides"] == g["strides"] == _bthd_strides(tq, h, d)
            assert k["strides"] == v["strides"] == (2 * h * d * 2, d * 2,
                                                    tk * 2 * h * d * 2)
        assert q["box"] == k["box"] == v["box"] == g["box"] == (d, 64)
        assert plan["swizzle"] == 2 * d  # one tile row: 64 or 128 bytes
        assert plan["threads"] == 128  # one warpgroup a block


@pytest.mark.parametrize("layout", ["kv", "bthd", "heads"])
@pytest.mark.parametrize("tq,tk,causal", [(136, 136, False), (136, 136, True),
                                          (1096, 1096, True),
                                          (512, 1024, True),
                                          (2048, 4096, True),
                                          (1096, 1096, False)])
def test_grids_cover_ragged_and_causal_lengths(monkeypatch, layout, tq, tk,
                                               causal):
    """dkv runs b*h on x and k tiles of 64 keys on y, dq q tiles of 64 rows
    on y, the last tile of each partly past its length (TMA zero-fills it,
    the kernels store nothing there); causal dq tiles run heaviest (the
    last, which see the most keys) first, dkv's first tiles already are."""
    launched = _fake_launches(monkeypatch)
    b, h, d = 2, 8, 64
    _run(layout, b, h, tq, tk, d, causal)
    for _, plan in _plans_of(launched):
        assert plan["dkv_grid"] == (b * h, -(-tk // 64))
        assert plan["dq_grid"] == (b * h, -(-tq // 64))
        assert plan["maps"]["q"]["dims"][1] == tq
        assert plan["maps"]["dout"]["dims"][1] == tq
        assert plan["maps"]["k"]["dims"][1] == tk
        assert plan["dq_heaviest_first"] == int(causal)


@pytest.mark.parametrize("d,dkv,dq", [(64, 92192, 50216),
                                      (32, 47136, 25640)])
def test_shared_memory_holds_the_rings(monkeypatch, d, dkv, dq):
    """dkv: k and v tiles, 3 stages of q, its scaled copy and dout (64 rows
    of d bf16 each), two buffers of 64 lse and 64 delta rows, 4 mbarriers;
    dq: q and dout tiles, 2 stages of k and v, 5 mbarriers; each with 1024
    bytes to align the tiles to the swizzle atom. Two dkv blocks and four
    dq blocks (each with the 1 KB the card reserves) fit an SM's 228 KB."""
    launched = _fake_launches(monkeypatch)
    _run("heads", 1, 2, 128, 128, d, True)
    for _, plan in _plans_of(launched):
        assert (plan["dkv_smem"], plan["dq_smem"]) == (dkv, dq)
    assert t_flash.bwd_smem_bytes(d) == (dkv, dq)
    tile = 64 * d * 2
    assert dkv == 11 * tile + 4 * 64 * 4 + 8 * 4 + 1024
    assert dq == 6 * tile + 8 * 5 + 1024
    assert 2 * (dkv + 1024) <= 228 * 1024 and 4 * (dq + 1024) <= 228 * 1024


def test_plan_is_cached_and_fp32_takes_none(monkeypatch):
    launched = _fake_launches(monkeypatch)
    _run("bthd", 2, 2, 256, 256, 64, True)
    _run("bthd", 2, 2, 256, 256, 64, True)
    plans = [args[PLAN_ARG[name]] for name, args in launched]
    assert len(plans) == 4 and all(p is plans[0] for p in plans)
    q = _bf16(2, 2, 256, 64)
    assert (t_flash.bwd_plan(q, q, q, q, False)
            is t_flash.bwd_plan(q, q, q, q, False))
    assert (t_flash.bwd_plan(q, q, q, q, False)
            is not t_flash.bwd_plan(q, q, q, q, True))
    launched.clear()
    for layout in ("kv", "bthd", "heads"):
        _run(layout, 2, 2, 256, 256, 64, False, dtype=torch.float32)
    assert [args[PLAN_ARG[name]] for name, args in launched] == [None] * 5


@pytest.mark.parametrize("case,match", [
    ("t stride", "t stride of 72 bytes"),
    ("b stride zero", "dout's b stride of 0 bytes"),
    ("base", "not 16-byte aligned"),
    ("last dim", "contiguous last dimension"),
])
def test_views_tma_cannot_take_are_refused(case, match):
    """bwd_plan names why TMA cannot take a view: a byte stride that is not
    a positive multiple of 16 (a cotangent broadcast over the batch has
    stride 0), a base off 16 bytes, a strided last dim."""
    q = _bf16(2, 2, 128, 32)
    k, g = q, q
    if case == "t stride":  # rows of 36 elements: 72 bytes apart
        k = _bf16(2, 2, 128, 36)[..., :32]
    elif case == "b stride zero":  # one cotangent broadcast over the batch
        g = _bf16(1, 2, 128, 32).expand(2, 2, 128, 32)
    elif case == "base":
        k = _bf16(2 * 2 * 128 * 32 + 4)[4:].view(2, 2, 128, 32)
    else:
        k = _bf16(2, 2, 32, 128).transpose(2, 3)
    with pytest.raises(ValueError, match=match):
        t_flash.bwd_plan(q, k, q, g, False)


@pytest.mark.parametrize("kernel", [17, 18])
def test_split_backward_refuses_a_broadcast_cotangent_unlaunched(
        monkeypatch, kernel):
    """Through flash_bwd_dkv / flash_bwd_dq (the ring's calls): a cotangent
    expanded over the batch passes the row-alignment check (stride 0) and is
    refused by the plan before any launch."""
    launched = _fake_launches(monkeypatch)
    q = _bf16(2, 2, 128, 64)
    g = _bf16(1, 2, 128, 64).expand(2, 2, 128, 64)
    lse = torch.zeros(2, 2, 128)
    with pytest.raises(ValueError, match="dout's b stride of 0 bytes"):
        if kernel == 17:
            t_flash.flash_bwd_dkv(q, g, lse, lse, q, q, scale=0.1)
        else:
            t_flash.flash_bwd_dq(q, q, q, g, lse, lse, scale=0.1)
    assert launched == []


def test_kernel_10_makes_a_broadcast_cotangent_contiguous(monkeypatch):
    """flash_attention_bwd_bthd takes g as it comes (a sum's cotangent is a
    stride-0 broadcast) and hands the kernels a contiguous copy: the dout
    map steps as q's does."""
    launched = _fake_launches(monkeypatch)
    b, t, h, d = 2, 128, 2, 64
    q = _bf16(b, t, h, d)
    g = torch.ones((), dtype=torch.bfloat16).expand(b, t, h, d)
    t_flash.flash_attention_bwd_bthd(q, q, q, q, torch.zeros(b, t, h), g,
                                     scale=0.1)
    for _, plan in _plans_of(launched):
        assert plan["maps"]["dout"]["strides"] == _bthd_strides(t, h, d)
    (_, dkv_args), (_, dq_args) = launched
    assert dkv_args[3] == dq_args[3] != g.data_ptr()  # a new contiguous g


@pytest.mark.parametrize("kernel", [5, 10, 17, 18])
def test_each_backward_wrapper_reaches_a_launch_with_its_plan(monkeypatch,
                                                              kernel):
    """Each backward wrapper's launches carry the plan of its own views, the
    one bwd_plan gives for them, and bump the wrapper's launch count once."""
    launched = _fake_launches(monkeypatch)
    b, t, h, d = 2, 128, 2, 32
    z, lse = _bf16(b, t, h, d), torch.zeros(b, t, h)
    kv = _bf16(b, t, 2, h, d)
    heads = lambda x: x.transpose(1, 2)  # noqa: E731
    zh, lh = _bf16(b, h, t, d), torch.zeros(b, h, t)
    wrapper, call, views = {
        5: (t_flash.flash_attention_bwd_kv,
            lambda: t_flash.flash_attention_bwd_kv(z, kv, z, lse, z,
                                                   scale=0.1, causal=True),
            (heads(z), heads(kv[:, :, 0]), heads(kv[:, :, 1]), heads(z))),
        10: (t_flash.flash_attention_bwd_bthd,
             lambda: t_flash.flash_attention_bwd_bthd(
                 z, z, z, z, lse, z, scale=0.1, causal=True),
             (heads(z),) * 4),
        17: (t_flash.flash_bwd_dkv,
             lambda: t_flash.flash_bwd_dkv(zh, zh, lh, lh, zh, zh, scale=0.1,
                                           causal=True),
             (zh,) * 4),
        18: (t_flash.flash_bwd_dq,
             lambda: t_flash.flash_bwd_dq(zh, zh, zh, zh, lh, lh, scale=0.1,
                                          causal=True),
             (zh,) * 4),
    }[kernel]
    before = wrapper.launches
    call()
    assert wrapper.launches == before + 1
    want = t_flash.bwd_plan(*views, True).c_array()
    assert launched and all(args[PLAN_ARG[name]] is want
                            for name, args in launched)
