"""The bf16 flash forward's host plan (kernels 1, 9 and 16 on the wgmma/TMA
kernel of csrc/flash_attention.cu), checked through faked launches on the
CPU: everything the C side is handed is decided in ops/flash_attention.py.

- Each operand's rank-4 tensor map, (d, t, h, b) dims, byte strides of t, h
  and b taken from the view, and the (d, 128) box, for the three layouts
  (packed kv's k and v views included), at head width 32 and 64; the
  swizzle is one tile row (64 or 128 bytes).
- The grid (b*h, q tiles of 128 rows) at ragged lengths and at causal
  tq < tk; causal q tiles run heaviest first, others in order.
- The dynamic shared memory (q tile, two k/v stages, mbarriers, alignment
  slack) within the H100's 227 KB.
- A view TMA cannot take raises a ValueError naming the reason; fp32 takes
  no plan (its register-tiled kernel decides its grid on the C side).
The expected values are written out from the layouts, not from the plan
code.

The fp32 forward's order of work (csrc/flash_attention.cu's
flash_fwd_f32_kernel), emulated in torch in this file: 64-row q tiles,
32-key chunks up to the tile's last diagonal, the chunk's row max (the 8
lanes that hold a row's scores), alpha = exp(m_old - m), P = exp(S * scale
- m) with the mask on the diagonal and ragged chunks only, each lane's part
of the row sum (keys lane + 8j), O = alpha O + P V, then O / l and lse =
m + log l. Held against JAX's flash forward in interpret mode on the CPU
(as tests/test_torch_flash_long.py runs it) and the port's plain version,
within relative L2 1e-5 (fp32 sums of up to 256 terms in another order),
at head width 32 and 64, causal and not, tq < tk and ragged lengths.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_models_torch.ops import _build
from attention_models_torch.ops import flash_attention as t_flash
from attention_models_tpu.ops import flash_attention as j_flash


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


PLAN_ARG = {"amt_flash_fwd": 6, "amt_flash_fwd_kv": 4}


def _decode(arr):
    """The 33 plan values the C side reads, by name."""
    v = list(arr)
    assert len(v) == 33
    maps = {n: dict(dims=tuple(v[9 * i:9 * i + 4]),
                    strides=tuple(v[9 * i + 4:9 * i + 7]),
                    box=tuple(v[9 * i + 7:9 * i + 9]))
            for i, n in enumerate("qkv")}
    return dict(maps=maps, swizzle=v[27], grid=tuple(v[28:30]),
                threads=v[30], smem=v[31], heaviest_first=v[32])


def _plan_of(launched):
    ((name, args),) = launched
    return _decode(args[PLAN_ARG[name]])


def _run(layout, b, h, tq, tk, d, causal):
    """One bf16 forward through the wrapper of ``layout``."""
    z = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)  # noqa: E731
    with torch.no_grad():
        if layout == "kv":
            t_flash.flash_attention_bthd_kv(z(b, tq, h, d), z(b, tk, 2, h, d),
                                            causal=causal)
        elif layout == "bthd":
            t_flash.flash_attention_bthd(z(b, tq, h, d), z(b, tk, h, d),
                                         z(b, tk, h, d), causal=causal)
        else:
            t_flash.flash_forward(z(b, h, tq, d), z(b, h, tk, d),
                                  z(b, h, tk, d), scale=0.1, causal=causal)


def _bthd_strides(t, h, d):
    """Byte steps of t, h and b in a contiguous (b, t, h, d) bf16 tensor."""
    return (h * d * 2, d * 2, t * h * d * 2)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("layout", ["kv", "bthd", "heads"])
def test_tensor_maps_follow_each_layout(monkeypatch, layout, d):
    launched = _fake_launches(monkeypatch)
    b, h, tq, tk = 2, 3, 256, 384
    _run(layout, b, h, tq, tk, d, False)
    plan = _plan_of(launched)
    q, k, v = (plan["maps"][n] for n in "qkv")
    assert q["dims"] == (d, tq, h, b)
    assert k["dims"] == v["dims"] == (d, tk, h, b)
    if layout == "heads":
        assert q["strides"] == (d * 2, tq * d * 2, h * tq * d * 2)
        assert k["strides"] == v["strides"] == (d * 2, tk * d * 2,
                                                h * tk * d * 2)
    elif layout == "bthd":
        assert q["strides"] == _bthd_strides(tq, h, d)
        assert k["strides"] == v["strides"] == _bthd_strides(tk, h, d)
    else:  # k and v step over both halves of a packed (b, t, 2, h, d) row
        assert q["strides"] == _bthd_strides(tq, h, d)
        assert k["strides"] == v["strides"] == (2 * h * d * 2, d * 2,
                                                tk * 2 * h * d * 2)
    assert q["box"] == k["box"] == v["box"] == (d, 128)
    assert plan["swizzle"] == 2 * d  # one tile row: 64 or 128 bytes
    assert plan["threads"] == 384


@pytest.mark.parametrize("layout", ["kv", "bthd", "heads"])
@pytest.mark.parametrize("tq,tk,causal", [(136, 136, False), (136, 136, True),
                                          (1096, 1096, True),
                                          (512, 1024, True),
                                          (2048, 4096, True),
                                          (1096, 1096, False)])
def test_grid_covers_ragged_and_causal_lengths(monkeypatch, layout, tq, tk,
                                               causal):
    """The grid runs b*h on x and q tiles of 128 rows on y, the last one
    partly past tq (TMA zero-fills it, the kernel stores rows below tq);
    ragged key lengths need no padded copy (the map's t extent is tk)."""
    launched = _fake_launches(monkeypatch)
    b, h, d = 2, 8, 64
    _run(layout, b, h, tq, tk, d, causal)
    plan = _plan_of(launched)
    assert plan["grid"] == (b * h, -(-tq // 128))
    assert plan["maps"]["q"]["dims"][1] == tq
    assert plan["maps"]["k"]["dims"][1] == plan["maps"]["v"]["dims"][1] == tk
    assert plan["heaviest_first"] == int(causal)


@pytest.mark.parametrize("d,want", [(64, 83000), (32, 42040)])
def test_shared_memory_holds_the_ring(monkeypatch, d, want):
    """q tile + 2 stages of k and v tiles (128 rows of d bf16 each), seven
    mbarriers, 1024 bytes to align the tiles to the swizzle atom."""
    launched = _fake_launches(monkeypatch)
    _run("heads", 1, 2, 128, 128, d, True)
    plan = _plan_of(launched)
    assert plan["smem"] == t_flash.fwd_smem_bytes(d) == want
    assert want == 5 * 128 * d * 2 + 8 * 7 + 1024
    assert want <= 232448  # the shared memory an H100 block may take


def test_extent_one_dims_take_a_placeholder_stride(monkeypatch):
    """A dim of extent 1 is never stepped, so its (any) stride becomes 16
    bytes, which TMA accepts; others keep the view's."""
    launched = _fake_launches(monkeypatch)
    q = torch.zeros(1, 1, 256, 64, dtype=torch.bfloat16)
    kv = torch.zeros(1, 1, 256, 2 * 64, dtype=torch.bfloat16)
    with torch.no_grad():
        t_flash.flash_forward(q, kv[..., :64], kv[..., 64:], scale=0.1)
    plan = _plan_of(launched)
    assert plan["maps"]["q"]["strides"] == (128, 16, 16)
    assert plan["maps"]["k"]["strides"] == plan["maps"]["v"]["strides"] == (
        256, 16, 16)


def test_plan_is_cached_and_fp32_takes_none(monkeypatch):
    launched = _fake_launches(monkeypatch)
    _run("bthd", 2, 2, 256, 256, 64, False)
    _run("bthd", 2, 2, 256, 256, 64, False)
    a, b = (args[PLAN_ARG[name]] for name, args in launched)
    assert list(a) == list(b)
    q = torch.zeros(2, 2, 256, 64, dtype=torch.bfloat16)
    assert t_flash.fwd_plan(q, q, q, False) is t_flash.fwd_plan(q, q, q,
                                                                False)
    launched.clear()
    z = torch.zeros(2, 256, 2, 64)
    with torch.no_grad():
        t_flash.flash_attention_bthd(z, z, z)
        t_flash.flash_attention_bthd_kv(z, torch.zeros(2, 256, 2, 2, 64))
    assert [args[PLAN_ARG[name]] for name, args in launched] == [None, None]


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case,match", [
    ("t stride", "t stride of 72 bytes"),
    ("b stride zero", "b stride of 0 bytes"),
    ("base", "not 16-byte aligned"),
    ("last dim", "contiguous last dimension"),
])
def test_views_tma_cannot_take_are_refused(case, match):
    """fwd_plan names why TMA cannot take a view: a byte stride that is not
    a positive multiple of 16, a base off 16 bytes, a strided last dim."""
    q = _bf16(2, 2, 128, 32)
    if case == "t stride":  # rows of 36 elements: 72 bytes apart
        k = _bf16(2, 2, 128, 36)[..., :32]
    elif case == "b stride zero":  # one k broadcast over the batch
        k = _bf16(1, 2, 128, 32).expand(2, 2, 128, 32)
    elif case == "base":
        k = _bf16(2 * 2 * 128 * 32 + 4)[4:].view(2, 2, 128, 32)
    else:
        k = _bf16(2, 2, 32, 128).transpose(2, 3)
    with pytest.raises(ValueError, match=match):
        t_flash.fwd_plan(q, k, q, False)


def test_wrapper_refuses_a_broadcast_k_before_launching(monkeypatch):
    """Through flash_forward: a k expanded over the batch passes the
    row-alignment check (stride 0) and is refused by the plan, unlaunched."""
    launched = _fake_launches(monkeypatch)
    q = _bf16(2, 2, 128, 64)
    k = _bf16(1, 2, 128, 64).expand(2, 2, 128, 64)
    with pytest.raises(ValueError, match="b stride of 0 bytes"):
        with torch.no_grad():
            t_flash.flash_forward(q, k, q, scale=0.1)
    assert launched == []



# -- the fp32 forward's chunked online softmax, emulated ----------------------

OWN, CHUNK, LANES = 64, 32, 8


def _fp32_forward_emulated(q, k, v, scale, causal):
    """q, k, v (b, h, t, d) fp32 -> (out, lse (b, h, tq)) in the kernel's
    order of work."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    off = tk - tq
    out = torch.empty_like(q)
    lse = torch.empty(b, h, tq)
    neg = -1e30
    for q0 in range(0, tq, OWN):
        qt = q[:, :, q0:q0 + OWN]
        rows = torch.arange(q0, q0 + qt.shape[2])[:, None]
        kend = min(tk, q0 + OWN + off) if causal else tk
        nfull = (min(tk, q0 + off + 1) if causal else tk) // CHUNK
        m = torch.full(qt.shape[:3], neg)
        lpart = torch.zeros(*qt.shape[:3], LANES)
        o = torch.zeros_like(qt)
        for c, k0 in enumerate(range(0, kend, CHUNK)):
            kc, vc = k[:, :, k0:k0 + CHUNK], v[:, :, k0:k0 + CHUNK]
            keys = torch.arange(k0, k0 + kc.shape[2])[None, :]
            s = (qt @ kc.transpose(-1, -2)) * scale
            hidden = torch.zeros_like(s, dtype=torch.bool)
            if c >= nfull:
                hidden = (keys >= tk) | (causal & (keys > rows + off))
                s = s.masked_fill(hidden, neg)
            mx = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - mx)
            p = torch.where(hidden, 0.0, torch.exp(s - mx[..., None]))
            # lane j % 8 holds keys j, j + 8, ..: its part of the row sum
            width = p.shape[-1]
            pad = torch.nn.functional.pad(p, (0, CHUNK - width))
            ps = pad.reshape(*p.shape[:3], CHUNK // LANES, LANES).sum(-2)
            lpart = lpart * alpha[..., None] + ps
            o = o * alpha[..., None] + p @ vc
            m = mx
        l_ = lpart.sum(-1)
        out[:, :, q0:q0 + OWN] = o / l_[..., None]
        lse[:, :, q0:q0 + OWN] = m + torch.log(l_)
    return out, lse


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# (causal, tq, tk, d): square, tq < tk, ragged (tk 200: a 32-key chunk of
# 8 keys; tq 72: a 64-row tile of 8 rows), head width 32 and 64
FP32_CASES = [(False, 128, 128, 64), (True, 128, 128, 64),
              (True, 64, 192, 32), (False, 72, 200, 32),
              (True, 72, 200, 64), (True, 200, 200, 32)]


@pytest.mark.parametrize("causal,tq,tk,d", FP32_CASES)
def test_fp32_forward_emulation_matches_jax(causal, tq, tk, d):
    rs = np.random.RandomState(tq + tk + d + causal)
    q, k, v = (rs.randn(1, 2, t, d).astype(np.float32)
               for t in (tq, tk, tk))
    scale = d ** -0.5
    o_j, lse_j = j_flash._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
        causal=causal, block_q=128, block_k=128, interpret=True)
    tq_, tk_, tv_ = map(torch.from_numpy, (q, k, v))
    o_e, lse_e = _fp32_forward_emulated(tq_, tk_, tv_, scale, causal)
    o_p, lse_p = t_flash._flash_forward_reference(tq_, tk_, tv_, scale,
                                                  causal)
    assert torch.isfinite(o_e).all() and torch.isfinite(lse_e).all()
    for got, want in ((o_e, np.asarray(o_j)), (lse_e, np.asarray(lse_j)),
                      (o_e, o_p.numpy()), (lse_e, lse_p.numpy())):
        assert _rel(got.numpy(), want) < 1e-5
