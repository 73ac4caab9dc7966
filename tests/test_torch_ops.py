"""The port's ops (attention_models_torch.ops) against the JAX package's.

Inputs come from numpy seeds and go through both. On the CPU every port
wrapper runs its plain version, which is held against the JAX function as it
dispatches on the CPU (its ``_*_reference`` / XLA path) and, in one small
case per kernel, against the Pallas kernel in interpret mode. Tolerance: fp32
max abs 1e-5 (summation order only); codebook indices exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_models_torch.ops import attention as t_attn
from attention_models_torch.ops import codebook as t_cb
from attention_models_torch.ops import ffn as t_ffn
from attention_models_torch.ops import flash_attention as t_flash
from attention_models_torch.ops import layernorm as t_ln
from attention_models_tpu.ops import attention as j_attn
from attention_models_tpu.ops import codebook as j_cb
from attention_models_tpu.ops import ffn as j_ffn
from attention_models_tpu.ops import flash_attention as j_flash
from attention_models_tpu.ops import layernorm as j_ln

TOL = 1e-5


def _np(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=0)


def test_l2_normalize_matches_jax():
    x = _np(np.random.RandomState(0), 16, 32)
    x[3] = 0.0  # the eps branch
    _close(t_cb.l2_normalize(torch.from_numpy(x)),
           j_cb.l2_normalize(jnp.array(x)))


@pytest.mark.parametrize("rows,d,with_beta", [(64, 512, True), (64, 192, True),
                                             (32, 256, False)])
def test_layernorm_plain_matches_jax(rows, d, with_beta):
    rs = np.random.RandomState(d)
    x = _np(rs, rows, d, scale=2.0) + 0.5
    g = 1.0 + _np(rs, d, scale=0.1)
    b = _np(rs, d, scale=0.1) if with_beta else None
    got = t_ln.layernorm(torch.from_numpy(x), torch.from_numpy(g),
                         None if b is None else torch.from_numpy(b))
    want = j_ln._ln_reference(jnp.array(x), jnp.array(g),
                              None if b is None else jnp.array(b), 1e-5)
    _close(got, want)


def test_layernorm_matches_pallas_interpret():
    rs = np.random.RandomState(1)
    x, g, b = _np(rs, 16, 128), _np(rs, 128), _np(rs, 128)
    want = j_ln.fused_layernorm(jnp.array(x), jnp.array(g), jnp.array(b),
                                interpret=True)
    got = t_ln.layernorm(*(torch.from_numpy(a) for a in (x, g, b)))
    _close(got, want)


def test_nearest_codes_plain_matches_jax_xla():
    rs = np.random.RandomState(2)
    z, codes = _np(rs, 512, 32), _np(rs, 1024, 32)
    want = np.asarray(j_cb._nearest_codes_xla(jnp.array(z), jnp.array(codes)))
    got = t_cb.nearest_codes(torch.from_numpy(z), torch.from_numpy(codes))
    assert got.dtype == torch.int32 and got.shape == (512,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_nearest_codes_bf16_operands_match_jax():
    """bf16 operands (the bf16 model's dot_dtype) through both paths."""
    rs = np.random.RandomState(3)
    z = t_cb.l2_normalize(torch.from_numpy(_np(rs, 256, 32)))
    codes = t_cb.l2_normalize(torch.from_numpy(_np(rs, 512, 32)))
    want = np.asarray(j_cb.nearest_codes(jnp.array(z.numpy()),
                                         jnp.array(codes.numpy()),
                                         dot_dtype=jnp.bfloat16))
    got = t_cb.nearest_codes(z.to(torch.bfloat16), codes.to(torch.bfloat16))
    np.testing.assert_array_equal(got.numpy(), want)


def test_nearest_codes_tie_takes_lowest_index():
    rs = np.random.RandomState(4)
    codes = _np(rs, 64, 16)
    codes[40] = codes[7]  # duplicate: the first copy must win
    codes[63] = codes[7]
    z = codes[[7, 40, 63, 5]] + 0.0
    want = np.asarray(j_cb._nearest_codes_xla(jnp.array(z), jnp.array(codes)))
    got = t_cb.nearest_codes(torch.from_numpy(z), torch.from_numpy(codes))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), [7, 7, 7, 5])


def test_nearest_codes_matches_pallas_interpret():
    from jax.experimental.pallas import tpu as pltpu

    rs = np.random.RandomState(5)
    z, codes = _np(rs, 256, 32), _np(rs, 512, 32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_cb._nearest_codes_pallas(
            jnp.array(z), jnp.array(codes), block_n=128, block_codes=128))
    got = t_cb.nearest_codes(torch.from_numpy(z), torch.from_numpy(codes))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tq,tk", [(8, 8), (6, 10)])
def test_make_causal_mask_matches_jax(tq, tk):
    np.testing.assert_array_equal(t_attn.make_causal_mask(tq, tk).numpy(),
                                  np.asarray(j_attn.make_causal_mask(tq, tk)))


@pytest.mark.parametrize("causal", [False, True])
def test_multihead_attention_matches_jax(causal):
    rs = np.random.RandomState(6)
    q, k, v = _np(rs, 2, 2, 8, 16), _np(rs, 2, 2, 12, 16), _np(rs, 2, 2, 12, 16)
    ctx = rs.rand(2, 12) > 0.3
    cm = np.array(j_attn.make_causal_mask(8, 12)) if causal else None
    want = j_attn.multihead_attention(
        jnp.array(q), jnp.array(k), jnp.array(v), scale=0.25,
        causal_mask=None if cm is None else jnp.array(cm),
        context_mask=jnp.array(ctx))
    got = t_attn.multihead_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), scale=0.25,
        causal_mask=None if cm is None else torch.from_numpy(cm),
        context_mask=torch.from_numpy(ctx))
    _close(got, want)


@pytest.mark.parametrize("causal,tq", [(False, 128), (True, 128), (True, 64)])
def test_flash_plain_matches_pallas_interpret(causal, tq):
    """out and the natural-log lse of the packed-kv forward, t 128, h 2,
    d 64, against the TPU kernel run in interpret mode."""
    rs = np.random.RandomState(7)
    q, kv = _np(rs, 1, tq, 2, 64), _np(rs, 1, 128, 2, 2, 64)
    out_j, lse_j = j_flash._flash_forward_bthd_kv(
        jnp.array(q), jnp.array(kv), scale=0.125, causal=causal,
        block_q=64, block_k=64, interpret=True)
    out_t, lse_t = t_flash.flash_attention_bthd_kv(
        torch.from_numpy(q), torch.from_numpy(kv), scale=0.125, causal=causal)
    _close(out_t, out_j)
    _close(lse_t, lse_j)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_bf16_keeps_the_kernel_rounding_points(causal):
    """bf16: the plain version rounds q * scale * log2(e) and P to bf16 as
    the TPU kernel does, so it sits closer to that kernel (interpret mode,
    t 256, 128-key blocks) than the same inputs through fp32 math; what is
    left is P's rounding under the kernel's running max (tol 2.5e-3)."""
    rs = np.random.RandomState(0)
    q, kv = _np(rs, 2, 256, 2, 64), _np(rs, 2, 256, 2, 2, 64)
    out_j, lse_j = j_flash._flash_forward_bthd_kv(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kv, jnp.bfloat16),
        scale=0.125, causal=causal, block_q=128, block_k=128, interpret=True)
    want = np.asarray(out_j, np.float32)
    qb, kvb = torch.from_numpy(q).bfloat16(), torch.from_numpy(kv).bfloat16()
    out, lse = t_flash._flash_reference(qb, kvb, 0.125, causal)
    f32, _ = t_flash._flash_reference(qb.float(), kvb.float(), 0.125, causal)

    def rel(a):
        return np.linalg.norm(a - want) / np.linalg.norm(want)

    assert out.dtype == torch.bfloat16
    assert rel(out.float().numpy()) < min(2.5e-3, rel(f32.numpy()))
    _close(lse, lse_j)


def test_flash_plain_matches_multihead_attention():
    rs = np.random.RandomState(8)
    q, kv = _np(rs, 2, 16, 2, 64), _np(rs, 2, 16, 2, 2, 64)
    want = j_attn.multihead_attention(
        jnp.array(q).swapaxes(1, 2), jnp.array(kv[:, :, 0]).swapaxes(1, 2),
        jnp.array(kv[:, :, 1]).swapaxes(1, 2), scale=0.125).swapaxes(1, 2)
    out, lse = t_flash.flash_attention_bthd_kv(torch.from_numpy(q),
                                               torch.from_numpy(kv))
    assert lse.shape == (2, 16, 2) and lse.dtype == torch.float32
    _close(out, want)


def test_flash_causal_rejects_tq_gt_tk():
    q, kv = torch.zeros(1, 16, 2, 64), torch.zeros(1, 8, 2, 2, 64)
    with pytest.raises(ValueError, match="tq <= tk"):
        t_flash.flash_attention_bthd_kv(q, kv, causal=True)
    with pytest.raises(ValueError, match="tq <= tk"):
        j_flash._check_causal_lengths(16, 8)


def test_gelu_exact_matches_jax():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    _close(t_ffn.gelu_exact(torch.from_numpy(x)),
           jax.nn.gelu(jnp.array(x), approximate=False))


def _mlp_params(rs, d, hid):
    return dict(
        lng=1.0 + _np(rs, d, scale=0.1), lnb=_np(rs, d, scale=0.1),
        w1=_np(rs, d, hid, scale=d ** -0.5), b1=_np(rs, hid, scale=0.1),
        w2=_np(rs, hid, d, scale=hid ** -0.5), b2=_np(rs, d, scale=0.1))


def _ln_mlp_both(x, p):
    """(port, jax) args: the port takes torch Linear layout (out, in)."""
    t = [torch.from_numpy(a) for a in (x, p["lng"], p["lnb"], p["w1"].T.copy(),
                                       p["b1"], p["w2"].T.copy(), p["b2"])]
    j = [jnp.array(p[k]) for k in ("lng", "lnb", "w1", "b1", "w2", "b2")]
    return t, [jnp.array(x)] + j


def test_ln_mlp_plain_matches_jax_reference():
    rs = np.random.RandomState(9)
    x = _np(rs, 2, 16, 128)
    t_args, j_args = _ln_mlp_both(x, _mlp_params(rs, 128, 344))
    _close(t_ffn.fused_ln_mlp(*t_args),
           j_ffn._ln_mlp_reference(*j_args, 1e-5))


def test_ln_mlp_matches_pallas_interpret():
    """The TPU kernel's erf is a polynomial within 1.5e-7 of the port's."""
    rs = np.random.RandomState(10)
    x = _np(rs, 32, 128)
    t_args, j_args = _ln_mlp_both(x, _mlp_params(rs, 128, 168))
    want = j_ffn.fused_ln_mlp(*j_args, block_rows=16, interpret=True)
    _close(t_ffn.fused_ln_mlp(*t_args), want)
