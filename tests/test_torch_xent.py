"""The port's fused head cross-entropy (attention_models_torch.ops.xent) and
the training ops beside it against the JAX package on the CPU.

``fused_head_xent`` runs its plain version on CPU tensors; it and
``_head_xent_backward_reference`` (the backward kernel's plain version) are
held against JAX's ``fused_head_xent`` in interpret mode (its Pallas
kernels) and against ``cross_entropy_ignore_index`` over ``jnp.dot(h, w)``.
Cases: ignored rows, every row ignored, Parti's bias, targets broadcast over
the batch. The port's head weight is the JAX kernel transposed (V, d).
Tolerances: fp32 1e-5 (the loss and every gradient; the products sum in
other orders). bf16 (logits rounded to bf16 before the fp32 softmax, dl
before both products, as the kernels do): the loss within relative 1e-3
and each gradient within relative L2 1e-2 of JAX's kernels; a logit that
sits on a bf16 rounding boundary may round the other way after a product
summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_models_torch.ops import sampling as t_sampling
from attention_models_torch.ops.xent import (
    _head_xent_backward_reference,
    _head_xent_reference,
    fused_head_xent,
    head_xent_supported,
)
from attention_models_tpu.ops import sampling as j_sampling
from attention_models_tpu.ops.xent import fused_head_xent as j_fused_head_xent

B, T, D, V = 2, 32, 128, 256


def _case(kind, seed=0):
    rs = np.random.RandomState(seed)
    h = rs.randn(B, T, D).astype(np.float32)
    w = (rs.randn(D, V) / np.sqrt(D)).astype(np.float32)
    bias = (rs.randn(V) * 0.1).astype(np.float32) if kind == "bias" else None
    tgt = rs.randint(0, V, size=(B, T)).astype(np.int32)
    tgt[0, :5] = -1
    tgt[1, 7::9] = -1
    if kind == "all_ignored":
        tgt[:] = -1
    if kind == "broadcast":
        tgt = tgt[:1]  # (1, T) against (B, T, D)
    return h, w, bias, tgt


def _jax_loss_and_grads(h, w, bias, tgt, dtype, fused):
    def loss(h, w, b):
        if fused:
            return j_fused_head_xent(h.astype(dtype), w, jnp.asarray(tgt),
                                     bias=b, block_rows=16, interpret=True)
        lg = jnp.dot(h.astype(dtype), w.astype(dtype))
        if b is not None:
            lg = lg + b.astype(dtype)
        return j_sampling.cross_entropy_ignore_index(lg, jnp.asarray(tgt))

    args = (jnp.asarray(h), jnp.asarray(w),
            None if bias is None else jnp.asarray(bias))
    argnums = (0, 1) if bias is None else (0, 1, 2)
    val, grads = jax.value_and_grad(loss, argnums=argnums)(*args)
    return float(val), [np.asarray(g, np.float32) for g in grads]


def _port_loss_and_grads(h, w, bias, tgt, dtype):
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w.T.copy()).requires_grad_(True)
    leaves = [th, tw]
    tb = None
    if bias is not None:
        tb = torch.from_numpy(bias).requires_grad_(True)
        leaves.append(tb)
    loss = fused_head_xent(th.to(dtype), tw, torch.from_numpy(tgt), bias=tb)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [np.zeros(p.shape, np.float32) if g is None else
             g.float().numpy() for g, p in zip(grads, leaves)]
    grads[1] = grads[1].T  # (V, d) -> JAX's (d, V)
    return float(loss), grads


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("kind", ["ignored", "all_ignored", "bias",
                                  "broadcast"])
@pytest.mark.parametrize("fused", [True, False], ids=["kernel", "unfused"])
def test_fused_head_xent_matches_jax_fp32(kind, fused):
    h, w, bias, tgt = _case(kind)
    want, jgrads = _jax_loss_and_grads(h, w, bias, tgt, jnp.float32, fused)
    got, tgrads = _port_loss_and_grads(h, w, bias, tgt, torch.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if kind == "all_ignored":
        assert got == 0.0
    for g, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(g, j, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(j).max(), 1e-6))


@pytest.mark.parametrize("kind", ["ignored", "bias"])
def test_fused_head_xent_matches_jax_kernel_bf16(kind):
    h, w, bias, tgt = _case(kind, seed=1)
    want, jgrads = _jax_loss_and_grads(h, w, bias, tgt, jnp.bfloat16, True)
    got, tgrads = _port_loss_and_grads(h, w, bias, tgt, torch.bfloat16)
    assert abs(got - want) <= 1e-3 * abs(want)
    for g, j in zip(tgrads, jgrads):
        assert _rel_l2(g, j) < 1e-2


@pytest.mark.parametrize("kind", ["ignored", "bias"])
def test_backward_reference_matches_jax_kernel(kind):
    """The backward kernel's plain version, given the forward's lse and the
    mean's per-row cotangent, against JAX's custom_vjp gradients."""
    h, w, bias, tgt = _case(kind, seed=2)
    _, jgrads = _jax_loss_and_grads(h, w, bias, tgt, jnp.float32, True)
    th = torch.from_numpy(h.reshape(-1, D))
    tw = torch.from_numpy(w.T.copy())
    tb = None if bias is None else torch.from_numpy(bias)
    tt = torch.from_numpy(tgt.reshape(-1))
    nll, lse = _head_xent_reference(th, tw, tt, bias=tb)
    valid = tt != -1
    coef = valid.float() / valid.sum()
    dh, dw, db = _head_xent_backward_reference(th, tw, tt, lse, coef, tb)
    got = [dh.reshape(h.shape).numpy(), dw.T.numpy()]
    if bias is not None:
        got.append(db.numpy())
    else:
        assert db is None
    for g, j in zip(got, jgrads):
        np.testing.assert_allclose(g, j, rtol=1e-5,
                                   atol=1e-5 * np.abs(j).max())
    # an ignored row's nll is its lse (the kernel's garbage, masked)
    np.testing.assert_allclose(nll[~valid].numpy(), lse[~valid].numpy())


def test_head_xent_supported_is_the_jax_gate():
    assert head_xent_supported((8, 1024, 768), 768, 8192)
    assert not head_xent_supported((2, 3, 128), 128, 256)   # 6 rows
    assert not head_xent_supported((8, 128), 128, 200)      # vocab
    assert not head_xent_supported((8, 96), 96, 256)        # d


@pytest.mark.parametrize("broadcast", [False, True])
def test_cross_entropy_ignore_index_matches_jax(broadcast):
    rs = np.random.RandomState(5)
    logits = (rs.randn(3, 16, 40) * 2).astype(np.float32)
    tgt = rs.randint(0, 40, size=(1 if broadcast else 3, 16)).astype(np.int32)
    tgt[..., ::3] = -1
    want = j_sampling.cross_entropy_ignore_index(jnp.asarray(logits),
                                                 jnp.asarray(tgt))
    got = t_sampling.cross_entropy_ignore_index(torch.from_numpy(logits),
                                                torch.from_numpy(tgt))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    none = t_sampling.cross_entropy_ignore_index(
        torch.from_numpy(logits), torch.full((3, 16), -1))
    assert float(none) == 0.0
