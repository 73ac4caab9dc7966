"""The per-head and separate-k/v flash attention (kernels 9, 10, 16, 17 and
18), the flash kernels' head widths, and the long-context entry point,
against the JAX package on the CPU.

- The port's plain ``flash_attention`` (b, h, t, d) and
  ``flash_attention_bthd`` (b, t, h, d), forward and gradients, against
  JAX's ``flash_attention`` / ``flash_attention_bthd`` in interpret mode:
  fp32 within 2e-4 (JAX's own tolerance against XLA), bf16 within relative
  L2 1e-2 (the plain versions round where the Hopper kernels do; JAX's
  backward forms S from unrounded q).
- The split backward: ``flash_bwd_dkv`` and ``flash_bwd_dq`` against JAX's
  on one given global lse and delta, and ``flash_forward``'s lse against
  JAX's ``_flash_forward``.
- Every flash kernel takes head width 32 and 64 in both dtypes and refuses
  any other width with a ValueError naming it (the launch faked).
- The plain versions' query-row chunks change no result; the kv-batch
  refusal of ``SoftmaxAttention`` keeps its reason; the long-context entry
  point runs on the CPU when asked.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_models_torch import longcontext as t_long
from attention_models_torch.models.attention import SoftmaxAttention
from attention_models_torch.ops import _build
from attention_models_torch.ops import flash_attention as t_flash
from attention_models_tpu.ops import flash_attention as j_flash


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _check(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    else:
        assert _rel_l2(got, want) < 1e-2


def _inputs(seed, shapes, dtype):
    """numpy draws, rounded to ``dtype``, as a JAX and a torch copy each."""
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(*s).astype(np.float32) for s in shapes]
    jd = jnp.dtype(dtype)
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


# -- plain versions against JAX's kernels in interpret mode -------------------

FLASH_CASES = [("float32", False, 128, 256, 64), ("float32", True, 128, 128, 32),
               ("bfloat16", True, 128, 256, 64),
               ("bfloat16", False, 128, 128, 32)]


@pytest.mark.parametrize("dtype,causal,tq,tk,d", FLASH_CASES)
def test_flash_attention_plain_matches_jax(dtype, causal, tq, tk, d):
    (q, k, v, g), (qt, kt, vt, gt) = _inputs(
        tq + d, [(2, 2, tq, d), (2, 2, tk, d), (2, 2, tk, d), (2, 2, tq, d)],
        dtype)
    out_j, vjp = jax.vjp(lambda q, k, v: j_flash.flash_attention(
        q, k, v, causal=causal, block_q=128, block_k=128, interpret=True),
        q, k, v)
    grads_j = vjp(g)
    leaves = [x.requires_grad_(True) for x in (qt, kt, vt)]
    out_t = t_flash.flash_attention(*leaves, causal=causal)
    grads_t = torch.autograd.grad(out_t, leaves, gt)
    _check(out_t.detach(), out_j, dtype)
    for a, b in zip(grads_t, grads_j):
        _check(a, b, dtype)


@pytest.mark.parametrize("dtype,causal,tq,tk,d", FLASH_CASES[:3])
def test_flash_attention_bthd_plain_matches_jax(dtype, causal, tq, tk, d):
    (q, k, v, g), (qt, kt, vt, gt) = _inputs(
        7 + tk, [(2, tq, 2, d), (2, tk, 2, d), (2, tk, 2, d), (2, tq, 2, d)],
        dtype)
    out_j, vjp = jax.vjp(lambda q, k, v: j_flash.flash_attention_bthd(
        q, k, v, causal=causal, block_q=128, block_k=128, interpret=True),
        q, k, v)
    grads_j = vjp(g)
    leaves = [x.requires_grad_(True) for x in (qt, kt, vt)]
    out_t, lse_t = t_flash.flash_attention_bthd(*leaves, causal=causal)
    assert lse_t.shape == (2, tq, 2) and lse_t.dtype == torch.float32
    grads_t = torch.autograd.grad(out_t, leaves, gt)
    _check(out_t.detach(), out_j, dtype)
    for a, b in zip(grads_t, grads_j):
        _check(a, b, dtype)
    # the explicit backward the kernel pair is held against on the card
    explicit = t_flash.flash_attention_bwd_bthd(
        *(x.detach() for x in leaves), out_t.detach(), lse_t, gt,
        scale=d ** -0.5, causal=causal)
    for a, b in zip(explicit, grads_t):
        torch.testing.assert_close(a, b, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype,causal,tq,tk", [("float32", True, 128, 128),
                                                ("bfloat16", False, 128, 256)])
def test_split_backward_matches_jax(dtype, causal, tq, tk):
    """flash_forward's lse, then flash_bwd_dkv / flash_bwd_dq on JAX's own
    global lse and delta, against the JAX kernels (interpret mode)."""
    d, scale = 64, 0.125
    (q, k, v, g), (qt, kt, vt, gt) = _inputs(
        3 + tk, [(1, 2, tq, d), (1, 2, tk, d), (1, 2, tk, d), (1, 2, tq, d)],
        dtype)
    o_j, lse_j = j_flash._flash_forward(q, k, v, scale=scale, causal=causal,
                                        block_q=128, block_k=128,
                                        interpret=True)
    o_t, lse_t = t_flash.flash_forward(qt, kt, vt, scale=scale, causal=causal)
    _check(o_t, o_j, dtype)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=1e-4,
                               atol=1e-4 if dtype == "float32" else 2e-2)
    delta_j = j_flash.flash_delta(o_j, g)
    kw = dict(scale=scale, causal=causal, block_q=128, block_k=128,
              interpret=True)
    dk_j, dv_j = j_flash.flash_bwd_dkv(q, g, lse_j, delta_j, k, v, **kw)
    dq_j = j_flash.flash_bwd_dq(k, v, q, g, lse_j, delta_j, **kw)
    lse_g = torch.from_numpy(np.asarray(lse_j))
    delta_g = torch.from_numpy(np.asarray(delta_j))
    dk_t, dv_t = t_flash.flash_bwd_dkv(qt, gt, lse_g, delta_g, kt, vt,
                                       scale=scale, causal=causal)
    dq_t = t_flash.flash_bwd_dq(kt, vt, qt, gt, lse_g, delta_g, scale=scale,
                                causal=causal)
    for a, b, like in ((dq_t, dq_j, qt), (dk_t, dk_j, kt), (dv_t, dv_j, vt)):
        assert a.dtype == like.dtype
        _check(a, b, dtype)


def test_row_chunks_change_no_result():
    """The chunked plain versions (what the card holds t 16384 against)
    compute each row as the whole one does."""
    rs = np.random.RandomState(5)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, g = (torch.from_numpy(rs.randn(1, 2, 192, 32).astype(
            np.float32)).to(dtype) for _ in range(4))
        whole = t_flash._flash_forward_reference(q, k, v, 0.2, True)
        parts = t_flash._flash_forward_reference(q, k, v, 0.2, True, chunk=64)
        assert all(torch.equal(a, b) for a, b in zip(whole, parts))
        o, lse = whole
        whole = t_flash._flash_backward_heads_reference(q, k, v, o, lse, g,
                                                        0.2, True)
        parts = t_flash._flash_backward_heads_reference(q, k, v, o, lse, g,
                                                        0.2, True, chunk=64)
        tol = 1e-5 if dtype == torch.float32 else 8e-3  # dk, dv: one ulp
        for a, b in zip(whole, parts):  # (fp32 sums in two orders)
            torch.testing.assert_close(a, b, rtol=tol, atol=tol)


# -- head widths: the repair of kernels 1 and 5, and the new kernels ---------

def _fake_launches(monkeypatch):
    """The kernel path without a card: wrappers take CPU tensors as if they
    were on it and each launch records its name and scalar arguments."""
    launched = []
    monkeypatch.setattr(t_flash, "is_kernel_path", lambda t: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "launch",
                        lambda name, *a: launched.append((name, a)))
    return launched


def _kernel_calls(d, dtype):
    """One call of each flash kernel's wrapper at head width d: (kernel,
    call, the C entries it launches)."""
    z = lambda *s: torch.zeros(*s, dtype=dtype)  # noqa: E731
    f = lambda *s: torch.zeros(*s)  # noqa: E731
    q, kv = z(2, 128, 2, d), z(2, 128, 2, 2, d)
    k = v = z(2, 128, 2, d)
    qh = kh = vh = z(2, 2, 128, d)
    lse_b, lse_h = f(2, 128, 2), f(2, 2, 128)
    return [
        (1, lambda: t_flash.flash_attention_bthd_kv(q, kv), ["amt_flash_fwd_kv"]),
        (5, lambda: t_flash.flash_attention_bwd_kv(q, kv, q, lse_b, q,
                                                   scale=0.1),
         ["amt_flash_bwd_kv"]),
        (9, lambda: t_flash.flash_attention_bthd(q, k, v), ["amt_flash_fwd"]),
        (10, lambda: t_flash.flash_attention_bwd_bthd(q, k, v, q, lse_b, q,
                                                      scale=0.1),
         ["amt_flash_bwd_dkv", "amt_flash_bwd_dq"]),
        (16, lambda: t_flash.flash_forward(qh, kh, vh, scale=0.1),
         ["amt_flash_fwd"]),
        (17, lambda: t_flash.flash_bwd_dkv(qh, qh, lse_h, lse_h, kh, vh,
                                           scale=0.1), ["amt_flash_bwd_dkv"]),
        (18, lambda: t_flash.flash_bwd_dq(kh, vh, qh, qh, lse_h, lse_h,
                                          scale=0.1), ["amt_flash_bwd_dq"]),
    ]


# where each C entry takes the head width (ops/_build.py's signatures)
D_ARG = {"amt_flash_fwd_kv": 9, "amt_flash_bwd_kv": 12, "amt_flash_fwd": 11,
         "amt_flash_bwd_dkv": 14, "amt_flash_bwd_dq": 13}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64])
def test_every_flash_kernel_takes_head_width(monkeypatch, d, dtype):
    launched = _fake_launches(monkeypatch)
    for kernel, call, entries in _kernel_calls(d, dtype):
        launched.clear()
        with torch.no_grad():
            call()
        assert [n for n, _ in launched] == entries, kernel
        for name, args in launched:  # the width reaches the C entry
            assert args[D_ARG[name]] == d, (kernel, name)


@pytest.mark.parametrize("d", [16, 48, 128])
def test_flash_kernels_refuse_other_widths(monkeypatch, d):
    launched = _fake_launches(monkeypatch)
    for kernel, call, _ in _kernel_calls(d, torch.bfloat16):
        with pytest.raises(ValueError, match=f"head dim {d}"):
            with torch.no_grad():
                call()
    assert launched == []


def test_kernel_operand_rules(monkeypatch):
    """Strided views are taken in place (k and v as views of a packed kv,
    the (b, h, t, d) transpose of a (b, t, h, d) tensor); a non-contiguous
    last dimension or an unaligned row is refused."""
    launched = _fake_launches(monkeypatch)
    kv = torch.zeros(1, 128, 2, 2, 32, dtype=torch.bfloat16)
    q = torch.zeros(1, 128, 2, 32, dtype=torch.bfloat16)
    with torch.no_grad():
        t_flash.flash_attention_bthd(q, kv[:, :, 0], kv[:, :, 1])
        t_flash.flash_forward(q.transpose(1, 2), kv[:, :, 0].transpose(1, 2),
                              kv[:, :, 1].transpose(1, 2), scale=0.1)
    (_, a9), (_, a16) = launched
    # q, k and v: one layout, two routes to it
    assert list(a9[5])[:9] == list(a16[5])[:9]
    assert list(a9[5])[3:6] == [2 * 128 * 2 * 32, 32, 2 * 2 * 32]
    with pytest.raises(ValueError, match="contiguous last dimension"):
        t_flash.flash_attention_bthd(q, q, q.transpose(2, 3).contiguous()
                                     .transpose(2, 3))
    odd = torch.zeros(1, 128, 2, 36, dtype=torch.bfloat16)[..., :32]
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        t_flash.flash_attention_bthd(q, odd, odd)


# -- the model's kv-batch refusal and the long-context entry ------------------

def test_softmax_attention_refuses_a_kv_batch_unlike_q():
    attn = SoftmaxAttention(64, num_heads=2, dim_head=32)
    x, ctx = torch.zeros(2, 128, 64), torch.zeros(1, 128, 64)
    with pytest.raises(ValueError, match="reads k and v at q's batch index"):
        attn(x, context=ctx)
    assert attn(x, context=torch.zeros(2, 128, 64)).shape == (2, 128, 64)


def test_longcontext_runs_on_the_cpu_when_asked():
    rows = t_long.longcontext((128, 256), fwd_iters=1, grad_iters=1,
                              device="cpu")
    assert [r["t"] for r in rows] == [128, 256]
    assert all(r["fwd_ms"] > 0 and r["fwd_bwd_ms"] > 0 for r in rows)
    assert rows[0]["fwd_calls"] == 2 and rows[0]["fwd_bwd_calls"] == 3
    assert rows[0]["peak_bytes"] is None
    q, k, v = t_long.make_inputs(128, device="cpu")
    assert q.shape == (1, 8, 128, 64) and q.dtype == torch.bfloat16
    # bench.py's draws: RandomState(0), q then k then v
    want = np.random.RandomState(0).randn(2, 1, 8, 128, 64)[1]
    torch.testing.assert_close(k, torch.from_numpy(want).bfloat16())
