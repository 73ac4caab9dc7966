"""Gradients of the port's ops and the GAN losses' modules against the JAX
package, on the CPU.

Inputs come from numpy seeds and go through both. The port's wrappers run
their plain versions here (autograd through them, and the explicit plain
backward functions the kernels are held against on the card); the JAX side
runs its Pallas kernels in interpret mode through their custom VJPs.
Tolerances: fp32 max abs 1e-5 (flash, LayerNorm, losses) or 2e-5 (ln_mlp,
as tests/test_ops_ffn.py), relative L2 2e-2 in bf16 (P and dS are rounded to
bf16 inside the JAX kernel, not in the fp32 plain version), rtol 1e-4 for
the discriminator and LPIPS (a conv stack).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_models_torch.models.discriminator import NLayerDiscriminator
from attention_models_torch.ops import ffn as t_ffn
from attention_models_torch.ops import flash_attention as t_flash
from attention_models_torch.ops import layernorm as t_ln
from attention_models_torch.training import losses as t_losses
from attention_models_torch.utils.convert import (
    discriminator_from_jax,
    lpips_from_jax,
)
from attention_models_tpu.models.discriminator import (
    NLayerDiscriminator as JaxDiscriminator,
)
from attention_models_tpu.ops import ffn as j_ffn
from attention_models_tpu.ops import flash_attention as j_flash
from attention_models_tpu.ops import layernorm as j_ln
from attention_models_tpu.training import losses as j_losses


def _np(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _t(a, dtype=torch.float32, grad=False):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype) \
        .requires_grad_(grad)


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol, rtol=0)


def _rel_l2(got, want):
    a = got.detach().double().numpy()
    b = np.asarray(want, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


FLASH_CASES = [(False, 64, 64), (True, 32, 64)]  # (causal, tq, tk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,tq,tk", FLASH_CASES)
def test_flash_backward_matches_jax_vjp(dtype, causal, tq, tk):
    rs = np.random.RandomState(tq + tk + causal)
    q, kv = _np(rs, 2, tq, 2, 64), _np(rs, 2, tk, 2, 2, 64)
    g = _np(rs, 2, tq, 2, 64)
    jd = jnp.dtype(dtype)
    out_j, vjp = jax.vjp(
        lambda q, kv: j_flash.flash_attention_bthd_kv(
            q, kv, causal=causal, interpret=True),
        jnp.asarray(q, jd), jnp.asarray(kv, jd))
    dq_j, dkv_j = vjp(jnp.asarray(g, jd))
    td = getattr(torch, dtype)
    qt, kvt = _t(q, td, True), _t(kv, td, True)
    out_t, lse_t = t_flash.flash_attention_bthd_kv(qt, kvt, causal=causal)
    dq_t, dkv_t = torch.autograd.grad(out_t, (qt, kvt), _t(g, td))
    # the explicit plain backward the kernel is held against on the card
    dq_p, dkv_p = t_flash.flash_attention_bwd_kv(
        qt.detach(), kvt.detach(), out_t.detach(), lse_t, _t(g, td),
        scale=0.125, causal=causal)
    for got in ((dq_t, dkv_t), (dq_p, dkv_p)):
        for a, b in zip(got, (dq_j, dkv_j)):
            if dtype == "float32":
                _close(a, b, 1e-5)
            else:
                assert _rel_l2(a, np.asarray(b, np.float32)) < 2e-2


@pytest.mark.parametrize("causal,tq,tk", FLASH_CASES)
def test_flash_backward_reference_matches_jax_kernel(causal, tq, tk):
    """_flash_backward_reference against JAX's _flash_backward_bthd_kv
    (the Pallas backward in interpret mode) on the same o, lse and g."""
    rs = np.random.RandomState(7 + tq)
    q, kv = _np(rs, 2, tq, 2, 64), _np(rs, 2, tk, 2, 2, 64)
    g = _np(rs, 2, tq, 2, 64)
    o, lse = t_flash._flash_reference(_t(q), _t(kv), 0.125, causal)
    dq_j, dkv_j = j_flash._flash_backward_bthd_kv(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(o.numpy()),
        jnp.asarray(lse.numpy()), jnp.asarray(g), scale=0.125, causal=causal,
        block_q=512, block_k=1024, interpret=True)
    dq_t, dkv_t = t_flash._flash_backward_reference(
        _t(q), _t(kv), o, lse, _t(g), 0.125, causal)
    _close(dq_t, dq_j, 1e-5)
    _close(dkv_t, dkv_j, 1e-5)


def _ln_mlp_inputs(rs):
    d, hid = 128, 344
    return (_np(rs, 2, 16, d), 1.0 + _np(rs, d, scale=0.1),
            _np(rs, d, scale=0.1), _np(rs, d, hid, scale=d ** -0.5),
            _np(rs, hid, scale=0.1), _np(rs, hid, d, scale=hid ** -0.5),
            _np(rs, d, scale=0.1))


def test_ln_mlp_backward_matches_jax_vjp():
    rs = np.random.RandomState(8)
    x, lng, lnb, w1, b1, w2, b2 = _ln_mlp_inputs(rs)
    dy = _np(rs, *x.shape)
    _, vjp = jax.vjp(
        lambda *a: j_ffn.fused_ln_mlp(*a, block_rows=16, interpret=True),
        *(jnp.asarray(a) for a in (x, lng, lnb, w1, b1, w2, b2)))
    want = vjp(jnp.asarray(dy))
    want = (want[0], want[1], want[2], np.asarray(want[3]).T, want[4],
            np.asarray(want[5]).T, want[6])  # torch Linear layouts
    args = [_t(a, grad=True) for a in (x, lng, lnb, w1.T, b1, w2.T, b2)]
    got = torch.autograd.grad(t_ffn.fused_ln_mlp(*args), args, _t(dy))
    for a, b in zip(got, want):
        _close(a, b, 2e-5)
    plain = t_ffn.fused_ln_mlp_backward(*(a.detach() for a in args[:6]),
                                        _t(dy))
    for a, b in zip(plain, want):
        _close(a, b, 2e-5)


@pytest.mark.parametrize("with_beta", [True, False])
def test_layernorm_backward_matches_jax_vjp(with_beta):
    rs = np.random.RandomState(3)
    x = _np(rs, 16, 256, scale=2.0) + 0.5
    gamma, beta = 1.0 + _np(rs, 256, scale=0.1), _np(rs, 256, scale=0.1)
    dy = _np(rs, 16, 256)
    jargs = [jnp.asarray(x), jnp.asarray(gamma)] + (
        [jnp.asarray(beta)] if with_beta else [])
    _, vjp = jax.vjp(lambda *a: j_ln.layernorm(*a, interpret=True), *jargs)
    want = vjp(jnp.asarray(dy))
    targs = [_t(x, grad=True), _t(gamma, grad=True)] + (
        [_t(beta, grad=True)] if with_beta else [])
    y = t_ln.layernorm(*targs)
    for a, b in zip(torch.autograd.grad(y, targs, _t(dy)), want):
        _close(a, b, 1e-5)


@pytest.fixture(scope="module")
def discr_pair():
    imgs = np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32)
    jd = JaxDiscriminator(input_nc=3, ndf=16, n_layers=3)
    variables = jd.init(jax.random.key(0), jnp.asarray(imgs), train=False)
    td = NLayerDiscriminator(input_nc=3, ndf=16, n_layers=3)
    td.load_state_dict(discriminator_from_jax(variables["params"],
                                              variables["batch_stats"]),
                       strict=True)
    return jd, variables, td, imgs


def test_discriminator_eval_matches_jax(discr_pair):
    jd, variables, td, imgs = discr_pair
    want = jd.apply(variables, jnp.asarray(imgs), train=False)
    got = td.eval()(_t(imgs))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_discriminator_train_step_and_batch_stats_match_jax(discr_pair):
    """Train mode: batch statistics, the biased-variance running update
    with momentum 0.9 (flax), and the input gradient."""
    jd, variables, _, imgs = discr_pair
    td = NLayerDiscriminator(input_nc=3, ndf=16, n_layers=3)
    td.load_state_dict(discriminator_from_jax(variables["params"],
                                              variables["batch_stats"]))
    x = (imgs * 2.0).astype(np.float32)
    want, upd = jd.apply(variables, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    gx_j = jax.grad(lambda x: jnp.sum(jd.apply(
        variables, x, train=True, mutable=["batch_stats"])[0] ** 2))(
            jnp.asarray(x))
    xt = _t(x, grad=True)
    got = td.train()(xt)
    (gx_t,) = torch.autograd.grad(torch.sum(got ** 2), xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), rtol=1e-4,
                               atol=1e-6)
    stats = discriminator_from_jax(variables["params"], upd["batch_stats"])
    sd = td.state_dict()
    for k in stats:
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(sd[k].numpy(), stats[k].numpy(),
                                       rtol=1e-4, atol=1e-7, err_msg=k)


def test_gan_losses_match_jax(discr_pair):
    jd, variables, td, imgs = discr_pair
    rs = np.random.RandomState(5)
    fake_l, real_l = _np(rs, 2, 1, 6, 6), _np(rs, 2, 1, 6, 6)
    _close(t_losses.hinge_d_loss(_t(fake_l), _t(real_l)),
           j_losses.hinge_d_loss(jnp.asarray(fake_l), jnp.asarray(real_l)),
           1e-6)
    _close(t_losses.g_nonsaturating_loss(_t(fake_l)),
           j_losses.g_nonsaturating_loss(jnp.asarray(fake_l)), 1e-6)
    fake = rs.rand(2, 3, 32, 32).astype(np.float32)
    rng = jax.random.key(3)
    eta = np.array(jax.random.uniform(rng, (2, 1, 1, 1), jnp.float32))

    def j_gp(params):
        return j_losses.gradient_penalty(
            lambda x: jd.apply({**variables, "params": params}, x,
                               train=False),
            rng, jnp.asarray(imgs), jnp.asarray(fake))

    gp_j, dgp_j = jax.value_and_grad(j_gp)(variables["params"])
    td.eval()
    gp_t = t_losses.gradient_penalty(td, _t(imgs), _t(fake), eta=_t(eta))
    np.testing.assert_allclose(float(gp_t), float(gp_j), rtol=1e-4)
    # the penalty's gradient in the discriminator's parameters (the
    # second-order path through the convolutions)
    names = [k for k, _ in td.named_parameters()]
    grads = torch.autograd.grad(gp_t, list(td.parameters()),
                                allow_unused=True)  # conv_out.bias: none
    want = discriminator_from_jax(dgp_j, variables["batch_stats"])
    for k, g in zip(names, grads):
        w = want[k].numpy()
        g = torch.zeros_like(want[k]) if g is None else g
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)


def test_lpips_with_converted_weights_matches_jax():
    rs = np.random.RandomState(2)
    x, y = rs.rand(2, 3, 32, 32).astype(np.float32), \
        rs.rand(2, 3, 32, 32).astype(np.float32)
    jl = j_losses.LPIPS()
    params = jl.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(y))
    want = jl.apply(params, jnp.asarray(x), jnp.asarray(y))
    tl = t_losses.LPIPS()
    tl.load_state_dict(lpips_from_jax(params), strict=True)
    xt = _t(x, grad=True)
    got = tl(xt, _t(y))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4)
    gx_j = jax.grad(lambda a: jnp.sum(jl.apply(params, a, jnp.asarray(y))))(
        jnp.asarray(x))
    (gx_t,) = torch.autograd.grad(got.sum(), xt)
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), rtol=1e-4,
                               atol=1e-5 * float(np.abs(gx_j).max()))
