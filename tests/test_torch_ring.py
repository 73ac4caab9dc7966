"""The port's ring attention (``ops/ring_attention.py``) over n = 4 virtual
shards, against the JAX package's ring on its 4-device CPU mesh.

- The non-causal forward against JAX's ``ring_flash_attention`` in
  interpret mode (fp32, 2e-4: JAX's own tolerance against XLA).
- The causal forward and the gradients against ``jax.grad`` of
  ``multihead_attention`` with ``make_causal_mask`` (XLA): fp32 within
  2e-4, bf16 within relative L2 1e-2.
- A wrapped chunk whose P = exp(S - lse) overflows against the global lse:
  the causal ring's dq, dk and dv are finite and equal the full attention's
  (the dead partials are dropped with a select, not a multiply).
- n^2 launches of each kernel a ring makes (kernel 16 forward, 17 and 18
  backward), and the rotation that replaces ``ppermute``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_models_torch.ops import flash_attention as t_flash
from attention_models_torch.ops import ring_attention as t_ring
from attention_models_tpu.ops.attention import (
    make_causal_mask,
    multihead_attention,
)
from attention_models_tpu.ops.ring_attention import ring_flash_attention

N = 4


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _check(got, want, dtype):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    else:
        assert _rel_l2(got, want) < 1e-2


def _qkv(seed, shape, dtype="float32"):
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(*shape).astype(np.float32) for _ in range(4)]
    tdt = getattr(torch, dtype)
    # JAX takes the values the port's dtype holds, in fp32
    ts = [torch.from_numpy(a).to(tdt) for a in arrs]
    return [jnp.asarray(t.float().numpy()) for t in ts], ts


def test_ring_forward_matches_jax_ring():
    (q, k, v, _), (qt, kt, vt, _) = _qkv(0, (1, 2, 128, 32))
    mesh = jax.make_mesh((N,), ("seq",), devices=jax.devices()[:N])
    want = ring_flash_attention(q, k, v, mesh, seq_axis="seq", block_q=32,
                                block_k=32, interpret=True)
    got = t_ring.ring_flash_attention(qt, kt, vt, N)
    _check(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_ring_and_gradients_match_xla(dtype):
    (q, k, v, g), (qt, kt, vt, gt) = _qkv(1, (2, 2, 128, 32), dtype)
    scale = 32 ** -0.5
    cm = make_causal_mask(128, 128)

    def ref(q, k, v):
        return multihead_attention(q, k, v, scale=scale, causal_mask=cm)

    out_j, vjp = jax.vjp(ref, q, k, v)
    grads_j = vjp(g)
    leaves = [x.requires_grad_(True) for x in (qt, kt, vt)]
    out_t = t_ring.ring_flash_attention(*leaves, N, causal=True)
    grads_t = torch.autograd.grad(out_t, leaves, gt)
    _check(out_t, out_j, dtype)
    for a, b in zip(grads_t, grads_j):
        _check(a, b, dtype)


def _overflowing_inputs():
    """q and the keys of chunks 1-3 along one direction at |30|: a score of
    about 159 there, while shard 0's own keys (chunk 0) are small, so its
    global lse is about 4 and exp(S - lse) of a wrapped chunk overflows
    fp32."""
    rs = np.random.RandomState(3)
    d, t = 32, 128
    u = rs.randn(d)
    u /= np.linalg.norm(u)
    q = 30 * u + 0.1 * rs.randn(1, 2, t, d)
    k = 30 * u + 0.1 * rs.randn(1, 2, t, d)
    k[:, :, :t // N] = 0.5 * rs.randn(1, 2, t // N, d)
    v, g = rs.randn(1, 2, t, d), rs.randn(1, 2, t, d)
    return [torch.from_numpy(a.astype(np.float32)) for a in (q, k, v, g)]


def test_wrapped_chunk_overflow_is_discarded():
    q, k, v, g = _overflowing_inputs()
    scale = 32 ** -0.5
    full = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = t_flash.flash_attention(*full, causal=True)
    want = torch.autograd.grad(out, full, g)
    # the dead partial itself overflows: shard 0 against chunk 1 (the chunk
    # it holds at step 3, wrapped) with shard 0's global lse and delta
    c = q.shape[2] // N
    o, lse = t_flash.flash_forward(q, k, v, scale=scale, causal=True)
    delta = t_flash.flash_delta(o, g)
    dead = t_flash.flash_bwd_dq(k[:, :, c:2 * c], v[:, :, c:2 * c],
                                q[:, :, :c], g[:, :, :c], lse[:, :, :c],
                                delta[:, :, :c], scale=scale)
    assert not bool(torch.isfinite(dead).all())
    ring = [x.clone().requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(t_ring.ring_flash_attention(*ring, N,
                                                          causal=True),
                              ring, g)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=2e-4,
                                   atol=2e-4 * float(b.abs().max()))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_makes_n_squared_launches_of_each_kernel(monkeypatch, causal):
    calls = {"fwd": 0, "dkv": 0, "dq": 0}

    def counted(key, fn):
        def run(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(t_ring, "flash_forward",
                        counted("fwd", t_flash.flash_forward))
    monkeypatch.setattr(t_ring, "flash_bwd_dkv",
                        counted("dkv", t_flash.flash_bwd_dkv))
    monkeypatch.setattr(t_ring, "flash_bwd_dq",
                        counted("dq", t_flash.flash_bwd_dq))
    _, ts = _qkv(2, (1, 2, 96, 32))
    leaves = [x.requires_grad_(True) for x in ts[:3]]
    out = t_ring.ring_flash_attention(*leaves, 3, causal=causal)
    assert calls == {"fwd": 9, "dkv": 0, "dq": 0}
    torch.autograd.grad(out, leaves, ts[3])
    assert calls == {"fwd": 9, "dkv": 9, "dq": 9}
    with torch.no_grad():
        t_ring.ring_flash_attention(*ts[:3], 3, causal=causal)
    assert calls["fwd"] == 18


def test_shift_is_the_ring_rotation():
    """At step s shard i holds the chunk of shard (i - s) mod n."""
    held = list(range(N))
    for s in range(1, N + 1):
        held, = t_ring._shift(held)
        assert held == [(i - s) % N for i in range(N)]
    a, b = t_ring._shift(["a0", "a1"], ["b0", "b1"])
    assert (a, b) == (["a1", "a0"], ["b1", "b0"])
