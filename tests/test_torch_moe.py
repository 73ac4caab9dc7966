"""The port's top-k expert dispatch (attention_models_torch/ops/moe.py) and
MoE layer (models/moe.py) against the JAX package's on the CPU.

Sizes: tokens (2, 24), d_in 16, d_out 24, E 6 (dense) and 12 (scatter),
k 2, numpy seeds. Tolerances: fp32 within 1e-5 of the largest magnitude
(JAX runs at ``highest`` matmul precision, conftest.py); bf16, given the
same selection, within 1e-2 of it; the selection and the kept mask bit for
bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_models_torch.models.moe import MoELayer as TMoELayer
from attention_models_torch.ops import moe as tmoe
from attention_models_torch.utils.convert import moe_layer_from_jax
from attention_models_tpu.models.moe import MoELayer as JMoELayer
from attention_models_tpu.ops import moe as jmoe

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _inputs(e, seed=0, n=(2, 24), d_in=16, d_out=24):
    rs = np.random.RandomState(seed)
    x = rs.randn(*n, d_in).astype(np.float32)
    w = (rs.randn(e, d_in, d_out) * 0.25).astype(np.float32)
    b = (rs.randn(e, d_out) * 0.1).astype(np.float32)
    logits = rs.randn(*n, e).astype(np.float32)
    return x, w, b, logits


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_topk_gate_ties_go_to_the_lower_index(dtype):
    """Logits of a few small integers tie everywhere; lax.top_k sorts
    descending and breaks ties to the lower index. The selection is bit
    for bit; the weights within one ulp of their dtype (below 1, 2^-8 in
    bf16): the port rounds the exact sigmoid once, XLA's CPU bf16 logistic
    rounds inside (sigmoid(2) = 0.8808 reads 0.8828 there, 0.8789 here)."""
    tdt, jdt = DTYPES[dtype]
    rs = np.random.RandomState(1)
    logits = rs.randint(-2, 3, size=(64, 32)).astype(np.float32)
    logits[0] = 1.0  # every expert tied
    for k in (1, 2, 5):
        jw, jsel = jmoe.topk_gate(jnp.asarray(logits, jdt), k)
        tw, tsel = tmoe.topk_gate(torch.from_numpy(logits).to(tdt), k)
        np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
        assert tw.dtype == tdt
        np.testing.assert_allclose(
            _np(tw), np.asarray(jw.astype(jnp.float32)), rtol=0,
            atol=2.0 ** -8 if dtype == "bfloat16" else 2.0 ** -24)
    assert tsel[0].tolist() == list(range(5))


@pytest.mark.parametrize("impl", ["dense", "scatter", "auto"])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("bias", [True, False])
def test_moe_linear_fp32_matches_jax(impl, weighted, bias):
    """moe_linear_dense / _scatter (dropless and at capacity factor 1.0) /
    moe_linear's "auto" (E 12: the scatter) against JAX's."""
    e = 6 if impl == "dense" else 12
    x, w, b, logits = _inputs(e)
    jw, jsel = jmoe.topk_gate(jnp.asarray(logits), 2)
    tw, tsel = tmoe.topk_gate(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    jargs = (jnp.asarray(x), jnp.asarray(w), jsel,
             jw if weighted else None, jnp.asarray(b) if bias else None)
    targs = (torch.from_numpy(x), torch.from_numpy(w), tsel,
             tw if weighted else None, torch.from_numpy(b) if bias else None)
    if impl == "dense":
        pairs = [(jmoe.moe_linear_dense(*jargs),
                  tmoe.moe_linear_dense(*targs))]
    elif impl == "scatter":
        pairs = [(jmoe.moe_linear_scatter(*jargs, capacity_factor=cf),
                  tmoe.moe_linear_scatter(*targs, capacity_factor=cf))
                 for cf in (None, 1.0)]
    else:
        pairs = [(jmoe.moe_linear(*jargs, capacity_factor=1.0),
                  tmoe.moe_linear(*targs, capacity_factor=1.0))]
    for want, got in pairs:
        assert got.shape == want.shape and got.dtype == torch.float32
        _close(_np(got), want)


@pytest.mark.parametrize("impl", ["dense", "scatter"])
def test_moe_linear_bf16_matches_jax_given_the_selection(impl):
    """bf16 x, the fp32 bank cast to bf16 inside: both sides take the same
    selection and weights, so only the products' rounding differs."""
    e = 6 if impl == "dense" else 12
    x, w, b, logits = _inputs(e, seed=2)
    jw, jsel = jmoe.topk_gate(jnp.asarray(logits, jnp.bfloat16), 2)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).bfloat16()
    tsel = torch.from_numpy(np.array(jsel)).long()
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    if impl == "dense":
        want = jmoe.moe_linear_dense(jx, jnp.asarray(w), jsel, jw,
                                     jnp.asarray(b))
        got = tmoe.moe_linear_dense(tx, torch.from_numpy(w), tsel, tw,
                                    torch.from_numpy(b))
    else:
        want = jmoe.moe_linear_scatter(jx, jnp.asarray(w), jsel, jw,
                                       jnp.asarray(b), capacity_factor=1.0)
        got = tmoe.moe_linear_scatter(tx, torch.from_numpy(w), tsel, tw,
                                      torch.from_numpy(b),
                                      capacity_factor=1.0)
    assert got.dtype == torch.bfloat16
    _close(_np(got), np.asarray(want.astype(jnp.float32)), tol=1e-2)


def test_capacity_drops_the_same_pairs_as_jax():
    """Skewed routing (expert 0 takes most tokens) at capacity factors that
    drop pairs. Read JAX's kept pairs from its output: x = 1, d_in 1, and
    expert i's bank row the one-hot of i, so a token's output row is the
    sum of its kept experts' one-hots."""
    e, n = 8, 40
    rs = np.random.RandomState(3)
    logits = rs.randn(n, e).astype(np.float32)
    logits[:, 0] += 2.0
    logits[rs.rand(n) < 0.5, 3] += 1.5
    x = np.ones((n, 1), np.float32)
    w = np.eye(e, dtype=np.float32)[:, None, :]  # (E, 1, E)
    _, jsel = jmoe.topk_gate(jnp.asarray(logits), 2)
    _, tsel = tmoe.topk_gate(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    dropped = []
    for cf in (0.25, 0.5, 1.0, None):
        want = np.asarray(jmoe.moe_linear_scatter(
            jnp.asarray(x), jnp.asarray(w), jsel, capacity_factor=cf))
        jkeep = np.take_along_axis(want, np.asarray(jsel), 1) > 0.5
        pos, keep, cap = tmoe.expert_slots(tsel, e, cf)
        assert cap == tmoe.bucket_capacity(n, 2, e, cf)
        np.testing.assert_array_equal(keep.numpy().reshape(n, 2), jkeep)
        got = tmoe.moe_linear_scatter(torch.from_numpy(x),
                                      torch.from_numpy(w), tsel,
                                      capacity_factor=cf)
        np.testing.assert_array_equal(got.numpy(), want)
        dropped.append(int((~keep).sum()))
    # cf 0.25: capacity 3 (ceil(0.25 * 40 * 2 / 8) = 3); dropless at None
    assert dropped[0] > dropped[1] > 0 and dropped[-1] == 0, dropped


def _layer(e, impl, cf, seed=4):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 24, 16).astype(np.float32)
    jm = JMoELayer(16, 24, e, 2, impl=impl, capacity_factor=cf)
    params = jm.init(jax.random.key(seed), jnp.asarray(x))["params"]
    # a nonzero expert bias, so its gradient is not the only zero-init
    params = jax.tree.map(jnp.asarray, dict(params))
    params["experts_bias"] = jnp.asarray(
        rs.randn(e, 24).astype(np.float32) * 0.1)
    tm = TMoELayer(16, 24, e, 2, impl=impl, capacity_factor=cf)
    tm.load_state_dict(moe_layer_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    return x, jm, params, tm


@pytest.mark.parametrize("e,impl,cf", [(6, "auto", None), (12, "auto", 1.0),
                                       (6, "scatter", 0.5)])
def test_moe_layer_output_and_gradients_match_jax(e, impl, cf):
    """MoELayer's output and the gradients of sum(out * g) with respect to
    x and every parameter against jax.grad, fp32."""
    x, jm, params, tm = _layer(e, impl, cf)
    g = np.random.RandomState(5).randn(2, 24, 24).astype(np.float32)

    def loss(p, xx):
        out = jm.apply({"params": p}, xx)
        return jnp.sum(out * g), out

    (_, want), (jgp, jgx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm(xt)
    _close(_np(out), want)
    names = [k for k, _ in tm.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                [xt, *tm.parameters()])
    _close(_np(grads[0]), jgx)
    want_g = moe_layer_from_jax(jax.tree.map(np.asarray, jgp))
    assert set(want_g) == set(names)
    for name, got in zip(names, grads[1:]):
        _close(_np(got), want_g[name].numpy())
    if cf == 0.5:  # this capacity drops pairs
        _, sel = tmoe.topk_gate(tm.gate(torch.from_numpy(x)), 2)
        assert not bool(tmoe.expert_slots(sel, e, cf)[1].all())


def test_resolve_moe_impl():
    for e, want in ((1, "dense"), (8, "dense"), (9, "scatter"),
                    (32, "scatter")):
        assert tmoe.resolve_moe_impl("auto", e) == want
        assert jmoe.resolve_moe_impl("auto", e) == want
    assert tmoe.resolve_moe_impl("dense", 32) == "dense"
    with pytest.raises(ValueError, match="unknown moe impl"):
        tmoe.resolve_moe_impl("sparse", 4)
    with pytest.raises(ValueError, match="unknown moe impl"):
        TMoELayer(8, 8, 4, 2, impl="sparse")
