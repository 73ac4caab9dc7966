"""The port's W8A8 ops (attention_models_torch/ops/quant.py) against the JAX
package's (attention_models_tpu/ops/quant.py) on the CPU.

- The quantizers give bit-equal integers and scales, rows built to land on
  .5 ties (round half to even) and an all-zero row included.
- ``quant_dot``: fp32 relative L2 <= 1e-6 (the integer sums are exact on
  both sides; only the dequantising products round).
- The three plain versions against JAX's kernels in interpret mode (as
  tests/test_ops_quant.py runs them) and against JAX's references: fp32
  relative L2 <= 1e-5, bf16 <= 1e-2. The port sums the LayerNorm statistics
  in float64 and uses the true erf; the TPU kernels sum in fp32 and use the
  A&S erf, their references jnp.var and the true erf: all within an ulp or
  two, so the int8 codes agree and the outputs meet 1e-5.
- ``FeedForward`` under "int8" and "int8_wide", and a ViTVQGAN block under
  "int8" (its attention projections through ``quant_dot`` and its LN + MLP
  through kernel 21's plain version), against JAX's modules on the same
  weights: fp32 relative L2 <= 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_models_torch.models.layers import FeedForward as TFeedForward
from attention_models_torch.models.layers import Linear as TLinear
from attention_models_torch.models.layers import LayerNorm as TLayerNorm
from attention_models_torch.models.layers import Mlp as TMlp
from attention_models_torch.models.layers import ln_mlp_block
from attention_models_torch.models.vitvqgan import (
    ViTVQGANBlock as TBlock,
)
from attention_models_torch.ops import quant as tq
from attention_models_torch.utils import convert
from attention_models_tpu.models.layers import FeedForward as JFeedForward
from attention_models_tpu.models.vitvqgan import ViTVQGANBlock as JBlock
from attention_models_tpu.ops import quant as jq


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _weight_with_ties(seed):
    """(d_in 64, d_out 24) fp32: gaussian columns, a zero column, and
    columns whose scale is exactly 1.0 or 0.5 with entries on .5 ties."""
    rs = np.random.RandomState(seed)
    w = (0.05 * rs.randn(64, 24)).astype(np.float32)
    w[:, 3] = 0.0
    ties = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5, 4.5], np.float32)
    w[:, 5] = 0.0
    w[:8, 5], w[8, 5] = ties, 127.0          # scale 1.0
    w[:, 9] = 0.0
    w[:8, 9], w[8, 9] = ties / 2, 63.5       # scale 0.5
    return w


def test_quantize_weight_bit_equal_with_ties_and_a_zero_row():
    w = _weight_with_ties(0)
    jw, js = jq.quantize_weight(jnp.array(w))
    got = tq.quantize_weight(_t(w).T.contiguous())  # torch layout (out, in)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy().T, np.asarray(jw))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(js)[0])
    # the ties went to even, and the zero column stays zero
    assert got.q[5, :8].tolist() == [0, 2, 2, 0, -2, 126, -4, 4]
    assert got.q[9, :8].tolist() == [0, 2, 2, 0, -2, 126, -4, 4]
    assert not got.q[3].any() and float(got.scale[3]) > 0


def test_quantize_rows_bit_equal_with_ties_and_a_zero_row():
    x = _weight_with_ties(1).T.copy()  # rows: the columns above
    jx, js = jq._quantize_rows_f32(jnp.array(x))
    got_q, got_s = tq.quantize_rows(_t(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(js))
    assert not got_q[3].any()


@pytest.mark.parametrize("shape", [(2, 16, 64), (5, 64)])
def test_quant_dot_matches_jax(shape):
    rs = np.random.RandomState(2)
    x = rs.randn(*shape).astype(np.float32)
    x.reshape(-1, 64)[0] = 0.0  # an all-zero row
    w = (0.05 * rs.randn(64, 48)).astype(np.float32)
    want = np.asarray(jq.quant_dot(jnp.array(x), jnp.array(w),
                                   out_dtype=jnp.float32))
    got = tq.quant_dot(_t(x), tq.quantize_weight(_t(w).T.contiguous()))
    assert got.shape == shape[:-1] + (48,) and got.dtype == torch.float32
    assert _rel_l2(got.numpy(), want) <= 1e-6
    assert float(got.reshape(-1, 48)[0].abs().max()) == 0.0


def test_int_dot_is_exact_at_the_largest_sums():
    """|sum| up to 4096 * 127^2 > 2^24: the float64 product is exact and
    rounds once to fp32, as JAX's int32 -> float32 conversion does."""
    a = torch.full((3, 4096), 127, dtype=torch.int8)
    a[1] = -127
    w = torch.full((2, 4096), 127, dtype=torch.int8)
    w[1, :7] = -127
    want = (a.long() @ w.long().T).numpy().astype(np.int32).astype(np.float32)
    np.testing.assert_array_equal(tq.int_dot(a, w).numpy(), want)


def _ffn_case(seed, dtype, d=128, inner=256, n=64):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, n // 2, d).astype(np.float32)
    w1 = (0.05 * rs.randn(d, 2 * inner)).astype(np.float32)
    gamma = rs.uniform(0.5, 1.5, inner).astype(np.float32)
    w2 = (0.05 * rs.randn(inner, d)).astype(np.float32)
    jx = jnp.array(x).astype(dtype)
    tx = _t(x).to(getattr(torch, jnp.dtype(dtype).name))
    return ((jx, jnp.array(w1), jnp.array(gamma), jnp.array(w2)),
            (tx, _t(w1).T.contiguous(), _t(gamma), _t(w2).T.contiguous()))


def _check(got, kern, ref, dtype):
    got = got.float().numpy()
    tol = 1e-5 if dtype == jnp.float32 else 1e-2
    assert _rel_l2(got, np.asarray(kern, np.float32)) <= tol
    assert _rel_l2(got, np.asarray(ref, np.float32)) <= tol


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ffn_q8_plain_matches_jax_kernel_and_reference(dtype):
    (jx, jw1, jg, jw2), (tx, w1, g, w2) = _ffn_case(3, dtype)
    got = tq._ffn_q8_reference(tx, tq.quantize_weight(w1), g,
                               tq.quantize_weight(w2), 1e-5)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _check(got, jq.fused_ffn_q8(jx, jw1, jg, jw2, interpret=True),
           jq.ffn_q8_reference(jx, jw1, jg, jw2), dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ffn_q8wide_plain_matches_jax_kernel_and_reference(dtype):
    (jx, jw1, jg, jw2), (tx, w1, g, w2) = _ffn_case(8, dtype)
    got = tq._ffn_q8wide_reference(tx, w1, g, tq.quantize_weight(w2), 1e-5)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _check(got, jq.fused_ffn_q8wide(jx, jw1, jg, jw2, interpret=True),
           jq.ffn_q8wide_reference(jx, jw1, jg, jw2), dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ln_mlp_q8_plain_matches_jax_kernel_and_reference(dtype):
    """hid 184: like the tokenizer's 1368, a multiple of 8 but not of 16."""
    rs = np.random.RandomState(6)
    d, hid, n = 128, 184, 32
    x = rs.randn(n, d).astype(np.float32)
    lng = rs.uniform(0.5, 1.5, d).astype(np.float32)
    lnb = (0.1 * rs.randn(d)).astype(np.float32)
    w1 = (0.05 * rs.randn(d, hid)).astype(np.float32)
    b1 = (0.1 * rs.randn(hid)).astype(np.float32)
    w2 = (0.05 * rs.randn(hid, d)).astype(np.float32)
    b2 = (0.1 * rs.randn(d)).astype(np.float32)
    jargs = [jnp.array(a) for a in (x, lng, lnb, w1, b1, w2, b2)]
    jargs[0] = jargs[0].astype(dtype)
    tx = _t(x).to(getattr(torch, jnp.dtype(dtype).name))
    got = tq._ln_mlp_q8_reference(
        tx, _t(lng), _t(lnb), tq.quantize_weight(_t(w1).T.contiguous()),
        _t(b1), tq.quantize_weight(_t(w2).T.contiguous()), _t(b2), 1e-5)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _check(got, jq.fused_ln_mlp_q8(*jargs, interpret=True),
           jq.ln_mlp_q8_reference(*jargs), dtype)


def test_ln_rows_is_layernorm():
    x = torch.from_numpy(np.random.RandomState(4).randn(6, 96).astype(
        np.float32) * 3 + 1)
    g, b = torch.rand(96) + 0.5, torch.randn(96)
    want = torch.nn.functional.layer_norm(x.double(), (96,), g.double(),
                                          b.double(), 1e-5)
    assert _rel_l2(tq.ln_rows(x, g, b, 1e-5).numpy(), want.numpy()) < 1e-6


def _ff_sd(tree):
    sd = {}
    convert._feed_forward(tree, "ff", sd)
    return {k[len("ff."):]: v for k, v in sd.items()}


@pytest.mark.parametrize("quant", ["int8", "int8_wide"])
@pytest.mark.parametrize("dim,mult", [(128, 3), (64, 2)])
def test_feed_forward_quant_matches_jax(quant, dim, mult):
    """(128, 3): inner 256 passes the fused gate (the plain version on the
    CPU, JAX's reference off the TPU); (64, 2): inner 85 does not."""
    x = np.random.RandomState(2).randn(2, 16, dim).astype(np.float32)
    params = JFeedForward(dim, mult).init(jax.random.key(0),
                                          jnp.array(x))["params"]
    want = JFeedForward(dim, mult, quant=quant).apply({"params": params},
                                                      jnp.array(x))
    tm = TFeedForward(dim, mult, quant=quant)
    tm.load_state_dict(_ff_sd(params), strict=True)
    with torch.no_grad():
        got = tm(_t(x)).numpy()
    assert _rel_l2(got, np.asarray(want)) <= 1e-5


def test_vitvqgan_block_int8_matches_jax():
    """One ViTVQGAN block under "int8": quant_dot projections (wq, wkv
    unbiased, wo biased) and the int8 LN + MLP, t 16 (the plain
    attention on both sides)."""
    x = np.random.RandomState(5).randn(2, 16, 128).astype(np.float32)
    jm = JBlock(128, 2, 64, 256, quant="int8")
    params = jm.init(jax.random.key(3), jnp.array(x))["params"]
    sd = {}
    convert._blocks({"layers_0": params}, "b", sd)
    tm = TBlock(128, 2, 64, 256, quant="int8")
    tm.load_state_dict({k[len("b.layers.0."):]: v for k, v in sd.items()},
                       strict=True)
    with torch.no_grad():
        got = tm(_t(x)).numpy()
    assert _rel_l2(got, np.asarray(jm.apply({"params": params},
                                            jnp.array(x)))) <= 1e-5


def test_ln_mlp_block_int8_refuses_active_dropout():
    norm, mlp = TLayerNorm(128), TMlp(128, 96)
    x = torch.zeros(8, 128)
    with pytest.raises(ValueError, match="inference-only"):
        ln_mlp_block(x, norm, mlp, quant="int8", dropout=0.1,
                     deterministic=False)
    out = ln_mlp_block(x, norm, mlp, quant="int8", dropout=0.1)
    assert out.shape == x.shape


def test_quant_cache_quantizes_once_inside_the_block():
    lin = TLinear(64, 32, bias=False, quant="int8")
    seq = torch.nn.Sequential(lin)
    outside = lin.q8.get("weight", lin.weight)
    assert outside is not lin.q8.get("weight", lin.weight)  # afresh
    with tq.weights_quantized_once(seq):
        first = lin.q8.get("weight", lin.weight)
        assert lin.q8.get("weight", lin.weight) is first
    assert lin.q8.store is None
    with pytest.raises(ValueError, match="quant must be one of"):
        TLinear(4, 4, quant="int4")
