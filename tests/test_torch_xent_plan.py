"""The head cross-entropy forward (kernel 13, csrc/xent.cu) and its
backward's fp32 dl pass (kernel 14): the host plan and scratches through
faked launches on the CPU, and a torch emulation of the kernels' order of
work against the JAX package and the port's plain versions.

- Kernel 13 in bf16 runs on csrc/gemm_sm90.cuh's tile product (both
  operands K-major, tile width 128): its plan's maps, grid (the grid covers
  V), shared memory and cache; the partial scratch is (3, V / 128, n) fp32
  in both dtypes (fp32 takes no plan); views TMA cannot take are refused by
  name, a misaligned operand before any launch.
- Kernel 14's db partials: one row per 64 rows in bf16 (a warpgroup of
  each 128-row tile), one per 128-row tile in fp32.
- The emulation (in this file only): each row's (max, sum of exp, target
  logit) over every 128-column tile of the rounded logits, merged in column
  order, as the kernels' epilogues and xent_combine_kernel compute them;
  and the fp32 db as 128-row tile partials summed in order. Held against
  JAX's forward kernel in interpret mode (``_head_nll_fwd_call``; the JAX
  package has no separate plain forward, so its other reference is the
  logsumexp of ``jnp.dot`` in the same rounding) and the port's
  ``_head_xent_reference``; db against JAX's bias gradient through its
  kernels and the port's ``_head_xent_backward_reference``.
Tolerances: fp32 1e-6 relative (sums of a few hundred terms in another
order). bf16: the emulation rounds each logit exactly as the port's plain
version does (bit-equal logits), its nll and lse within 1e-6 relative of the
port's; against JAX relative L2 1e-3 over the rows, since a logit on a
bf16 rounding boundary may round the other way after a product summed in
another order (one bf16 ulp of a target logit moves its row's nll by up to
4e-3 relative).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_models_torch.ops import _build
from attention_models_torch.ops import gemm_sm90 as t_gemm
from attention_models_torch.ops import xent as t_xent
from attention_models_tpu.ops import xent as j_xent

SINGLE_SMEM = 3 * (128 + 128) * 64 * 2 + 3 * 16 + 1024      # 99376
TILE = 128


def _fake_launches(monkeypatch):
    """The kernel path without a card: each launch records its name and
    arguments, and each fp32 scratch the wrapper allocates its shape."""
    launched, scratch = [], []
    for mod in (t_xent, t_gemm):
        monkeypatch.setattr(mod, "is_kernel_path", lambda t: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "launch",
                        lambda name, *a: launched.append((name, a)))
    empty = torch.empty

    def recording_empty(*shape, **kw):
        out = empty(*shape, **kw)
        scratch.append((tuple(out.shape), out.dtype))
        return out
    monkeypatch.setattr(torch, "empty", recording_empty)
    return launched, scratch


def _decode(arr):
    """One plan of 21 values, by name."""
    p = list(arr)
    assert len(p) == 21
    return dict(
        a=dict(dims=tuple(p[0:2]), stride=p[2], box=tuple(p[3:5]),
               major=p[5]),
        b=dict(dims=tuple(p[6:8]), stride=p[8], box=tuple(p[9:11]),
               major=p[11]),
        swizzle=p[12], grid=tuple(p[13:16]), threads=p[16], smem=p[17],
        bn=p[18], ldc=p[19], kslices=p[20])


def kmap(k, rows, pitch):
    """A K-major bf16 map: (K, rows) dims, (64 K, 128 rows) boxes."""
    return dict(dims=(k, rows), stride=2 * pitch, box=(64, 128), major=0)


def _xent_fwd(monkeypatch, n, d, v, bias, dtype=torch.bfloat16):
    launched, scratch = _fake_launches(monkeypatch)
    h = torch.zeros(n, d, dtype=dtype)
    w = torch.zeros(v, d, dtype=dtype)
    tgt = torch.arange(n) % v
    t_xent._head_xent_fwd_kernel(h, w, torch.zeros(v) if bias else None, tgt)
    ((name, args),) = launched
    assert name == "amt_head_xent_fwd"
    assert args[8:12] == (n, d, v, _build.DTYPE_CODES[dtype])
    assert (args[2] is None) == (not bias)
    return args, scratch


# (n, d, V, bias): MaskGIT's training shape, ragged rows, a small head
KERNEL_13 = [(8192, 768, 8192, False), (8192, 768, 8192, True),
             (520, 768, 8192, False), (64, 128, 256, True)]


@pytest.mark.parametrize("n,d,v,bias", KERNEL_13)
def test_kernel_13_plan_covers_the_vocab(monkeypatch, n, d, v, bias):
    args, scratch = _xent_fwd(monkeypatch, n, d, v, bias)
    p = _decode(args[7])
    # logits = h W^T, both K-major as they lie
    assert p["a"] == kmap(d, n, d) and p["b"] == kmap(d, v, d)
    assert p["grid"] == (v // TILE, -(-n // 128), 1)
    assert (p["ldc"], p["kslices"], p["bn"]) == (v, -(-d // 64), TILE)
    assert (p["swizzle"], p["threads"], p["smem"]) == (128, 288, SINGLE_SMEM)
    # the partials: (max, sum, target logit) a row and column tile
    assert scratch[0] == ((3, v // TILE, n), torch.float32)


@pytest.mark.parametrize("n,d,v,bias", KERNEL_13)
def test_kernel_13_fp32_takes_no_plan_and_the_same_partials(monkeypatch, n, d,
                                                           v, bias):
    args, scratch = _xent_fwd(monkeypatch, n, d, v, bias,
                              dtype=torch.float32)
    assert args[7] is None
    assert scratch[0] == ((3, v // TILE, n), torch.float32)


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def _misaligned(*shape):
    return torch.zeros(int(np.prod(shape)) + 1,
                       dtype=torch.bfloat16)[1:].view(*shape)


def test_kernel_13_plan_is_cached_and_refuses_views():
    h, w = _bf16(64, 128), _bf16(256, 128)
    assert t_xent.xent_fwd_plan(h, w) is t_xent.xent_fwd_plan(h, w)
    with pytest.raises(ValueError, match="w needs a contiguous last"):
        t_xent.xent_fwd_plan(h, _bf16(128, 256).t())
    with pytest.raises(ValueError, match="h starts at an address"):
        t_xent.xent_fwd_plan(_misaligned(64, 128), w)


def test_kernel_13_refuses_a_misaligned_operand_unlaunched(monkeypatch):
    launched, _ = _fake_launches(monkeypatch)
    with pytest.raises(ValueError, match="16-byte aligned"):
        t_xent._head_xent_fwd_kernel(_misaligned(64, 128), _bf16(256, 128),
                                     None, torch.zeros(64, dtype=torch.long))
    assert launched == []


@pytest.mark.parametrize("dtype,rows", [(torch.bfloat16, 2 * 5),
                                        (torch.float32, 5)])
def test_kernel_14_db_partials_follow_the_row_tiles(monkeypatch, dtype, rows):
    """n 520: five 128-row tiles; bf16 writes a partial row per warpgroup
    (64 rows) of each, fp32 one per tile."""
    launched, scratch = _fake_launches(monkeypatch)
    n, d, v = 520, 128, 256
    t_xent.head_xent_backward(torch.zeros(n, d, dtype=dtype),
                              torch.zeros(v, d, dtype=dtype),
                              torch.arange(n) % v, torch.zeros(n),
                              torch.ones(n), bias=torch.zeros(v))
    ((name, args),) = launched
    assert name == "amt_head_xent_bwd"
    assert ((rows, v), torch.float32) in scratch
    assert ((n, v), dtype) in scratch  # dl


# -- the tile partials, emulated, against JAX and the plain versions --------

N, D, V = 64, 128, 512


def _case(seed, bias):
    rs = np.random.RandomState(seed)
    h = rs.randn(N, D).astype(np.float32)
    w = (rs.randn(V, D) / np.sqrt(D)).astype(np.float32)
    b = (rs.randn(V) * 0.5).astype(np.float32) if bias else None
    tgt = rs.randint(0, V, size=N).astype(np.int32)
    tgt[:7] = -1          # ignored
    tgt[7:9] = V + 3      # outside [0, V): picks nothing, as ignored
    return h, w, b, tgt


def _rounded_logits(h, w, b, dtype):
    """The logits as the kernels form them, in fp32."""
    lg = (h.float() @ w.to(dtype).float().T).to(dtype)
    if b is not None:
        lg = lg + b.to(dtype)
    return lg.float()


def _tile_partials(lg, tgt):
    """Each row's (max, sum of exp, target logit) over each 128-column tile,
    merged in column order: (nll, lse)."""
    m = s = tl = None
    for c0 in range(0, lg.shape[1], TILE):
        blk = lg[:, c0:c0 + TILE]
        bm = blk.max(dim=1).values
        bs = torch.exp(blk - bm[:, None]).sum(dim=1)
        inside = (tgt >= c0) & (tgt < c0 + TILE)
        bt = torch.where(inside, blk.gather(
            1, torch.where(inside, tgt - c0, 0).long()[:, None])[:, 0],
            torch.zeros_like(bm))
        if m is None:
            m, s, tl = bm, bs, bt
            continue
        mm = torch.maximum(m, bm)
        s = s * torch.exp(m - mm) + bs * torch.exp(bm - mm)
        m, tl = mm, tl + bt
    lse = m + torch.log(s)
    return lse - tl, lse


def _jax_kernel(h, w, b, tgt, jdt):
    nll, lse = j_xent._head_nll_fwd_call(
        16, True, jnp.asarray(h, jdt), jnp.asarray(w.T), None if b is None
        else jnp.asarray(b), jnp.asarray(tgt))
    return np.asarray(nll), np.asarray(lse).reshape(-1)


def _jax_plain(h, w, b, tgt, jdt):
    """logsumexp over jnp.dot in the kernels' rounding."""
    lg = jnp.dot(jnp.asarray(h, jdt), jnp.asarray(w.T, jdt),
                 preferred_element_type=jnp.float32).astype(jdt)
    if b is not None:
        lg = lg + jnp.asarray(b, jdt)
    lg = lg.astype(jnp.float32)
    lse = jnp.log(jnp.sum(jnp.exp(lg - lg.max(-1, keepdims=True)), -1)) + \
        lg.max(-1)
    inside = (tgt >= 0) & (tgt < V)
    tl = jnp.where(inside, jnp.take_along_axis(
        lg, jnp.asarray(np.where(inside, tgt, 0))[:, None], 1)[:, 0], 0.0)
    return np.asarray(lse - tl), np.asarray(lse)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tile_partials_match_jax_and_plain(dtype, bias):
    h, w, b, tgt = _case(3 + bias, bias)
    tdt = getattr(torch, dtype)
    th = torch.from_numpy(h).to(tdt)
    tw = torch.from_numpy(w)
    tb = None if b is None else torch.from_numpy(b)
    tt = torch.from_numpy(tgt)
    lg = _rounded_logits(th, tw, tb, tdt)
    assert torch.equal(lg, t_xent._logits(th, tw, tb))
    nll, lse = _tile_partials(lg, tt)
    nll_p, lse_p = t_xent._head_xent_reference(th, tw, tt, bias=tb)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    hj = th.float().numpy()  # the same (rounded) inputs
    nll_k, lse_k = _jax_kernel(hj, w, b, tgt, jdt)
    nll_j, lse_j = _jax_plain(hj, w, b, tgt, jdt)
    for got, want in ((nll, nll_p), (lse, lse_p)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=0)
    for got, want in ((nll, nll_k), (lse, lse_k), (nll, nll_j),
                      (lse, lse_j)):
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
        else:
            assert _rel(got.numpy(), want) < 1e-3


def test_db_row_tiles_match_jax_and_plain():
    """fp32 db as kernel 14's dl pass forms it: one column-sum row per
    128-row tile, the rows summed in order."""
    n = 296  # three row tiles, the last ragged
    rs = np.random.RandomState(5)
    h = rs.randn(n, D).astype(np.float32)
    w = (rs.randn(V, D) / np.sqrt(D)).astype(np.float32)
    b = (rs.randn(V) * 0.5).astype(np.float32)
    tgt = rs.randint(0, V, size=n).astype(np.int32)
    tgt[::5] = -1
    th, tw, tb, tt = map(torch.from_numpy, (h, w, b, tgt))
    _, lse = t_xent._head_xent_reference(th, tw, tt, bias=tb)
    valid = tt != -1
    coef = valid.float() / valid.sum()
    lg = _rounded_logits(th, tw, tb, torch.float32)
    onehot = torch.zeros_like(lg)
    onehot[valid, tt[valid].long()] = 1.0
    dl = (torch.exp(lg - lse[:, None]) - onehot) * coef[:, None]
    rows = [dl[r0:r0 + TILE].sum(dim=0) for r0 in range(0, n, TILE)]
    db = rows[0]
    for r in rows[1:]:
        db = db + r
    _, _, db_p = t_xent._head_xent_backward_reference(th, tw, tt, lse, coef,
                                                      tb)

    def loss(bias):
        return j_xent.fused_head_xent(jnp.asarray(h), jnp.asarray(w.T),
                                      jnp.asarray(tgt), bias=bias,
                                      block_rows=8, interpret=True)

    db_j = np.asarray(jax.grad(loss)(jnp.asarray(b)))
    np.testing.assert_allclose(db.numpy(), db_p.numpy(), rtol=1e-6,
                               atol=1e-9)
    assert _rel(db.numpy(), db_j) < 1e-6
