"""The fused GELU MLP (kernels 7 and 8) and the width repairs of the
ln_mlp, codebook and LayerNorm wrappers, against the JAX package on the CPU.

- Kernel 7's plain version against JAX's ``fused_mlp`` in interpret mode:
  fp32 within 1e-5 (max abs, relative to the output's largest magnitude);
  bf16 within relative L2 1e-2 of the interpreted kernel, whose rounding
  points (h and the gelu in fp32, g rounded to bf16) the plain version
  keeps (measured 2.1e-5: the A&S erf and the summation order). Against
  JAX's unfused ``_mlp_reference`` in bf16, which also rounds h to bf16,
  the measured gap is 4.6e-3 (held under 1e-2).
- Kernel 8's plain gradients against ``jax.vjp`` of the interpreted kernel:
  fp32 1e-5 (as above, per gradient), bf16 relative L2 2e-2.
- The choice between the fused block and the module composition in
  ``ln_mlp_block`` and ``Mlp`` equals the JAX package's own, its backend
  test answered as on a TPU, over a grid of rows, widths, dtypes and
  dropout states; every width the gate admits reaches a kernel launch on the
  card path (the launch faked), the wide ones with their scratches.
- Every code width and LayerNorm width the JAX package computes is taken by
  the port's kernel wrappers (launch faked), and their plain versions agree
  with JAX there.
- Mlp and ln_mlp_block dropout with given keep masks against flax's formula.
"""

import contextlib

import flax.linen as jnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_models_torch.models import layers as t_layers
from attention_models_torch.ops import _build
from attention_models_torch.ops import codebook as t_cb
from attention_models_torch.ops import ffn as t_ffn
from attention_models_torch.ops import layernorm as t_ln
from attention_models_tpu.models import layers as j_layers
from attention_models_tpu.ops import codebook as j_cb
from attention_models_tpu.ops import dispatch as j_dispatch
from attention_models_tpu.ops import ffn as j_ffn
from attention_models_tpu.ops import layernorm as j_ln


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _mlp_inputs(seed, hid=344):
    """x (2, 16, 128), JAX-layout weights w1 (d, hid), w2 (hid, d)."""
    rs = np.random.RandomState(seed)
    d = 128
    return dict(
        x=rs.randn(2, 16, d).astype(np.float32),
        w1=(rs.randn(d, hid) / np.sqrt(d)).astype(np.float32),
        b1=(rs.randn(hid) * 0.1).astype(np.float32),
        w2=(rs.randn(hid, d) / np.sqrt(hid)).astype(np.float32),
        b2=(rs.randn(d) * 0.1).astype(np.float32),
        dy=rs.randn(2, 16, d).astype(np.float32))


def _port_args(a, dt):
    return (_t(a["x"]).to(dt), _t(a["w1"]).T.contiguous(), _t(a["b1"]),
            _t(a["w2"]).T.contiguous(), _t(a["b2"]))


def _jax_kernel(x, w1, b1, w2, b2):
    return j_ffn.fused_mlp(x, w1, b1, w2, b2, block_rows=16, interpret=True)


# -- kernel 7's plain version ----------------------------------------------

def test_fused_mlp_plain_matches_jax_kernel_fp32():
    a = _mlp_inputs(0)
    want = _jax_kernel(*(jnp.asarray(a[k]) for k in ("x", "w1", "b1", "w2",
                                                    "b2")))
    got = t_ffn.fused_mlp(*_port_args(a, torch.float32))
    _close(got.numpy(), want)


def test_fused_mlp_plain_matches_jax_kernel_bf16():
    a = _mlp_inputs(1)
    jargs = (jnp.asarray(a["x"], jnp.bfloat16),
             *(jnp.asarray(a[k]) for k in ("w1", "b1", "w2", "b2")))
    want = np.asarray(_jax_kernel(*jargs), np.float32)
    got = t_ffn.fused_mlp(*_port_args(a, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert _rel_l2(got.float().numpy(), want) < 1e-2
    # JAX's unfused formulation rounds h to bf16 as well: a bf16-scale gap
    unfused = np.asarray(j_ffn._mlp_reference(*jargs), np.float32)
    assert _rel_l2(got.float().numpy(), unfused) < 1e-2


# -- kernel 8's plain version ----------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_backward_plain_matches_jax_kernel(dtype):
    a = _mlp_inputs(2 + (dtype == "bfloat16"))
    jdt = jnp.dtype(dtype)
    jargs = (jnp.asarray(a["x"], jdt),
             *(jnp.asarray(a[k]) for k in ("w1", "b1", "w2", "b2")))
    _, vjp = jax.vjp(_jax_kernel, *jargs)
    want = vjp(jnp.asarray(a["dy"], jdt))
    tdt = getattr(torch, dtype)
    x, w1, b1, w2, _ = _port_args(a, tdt)
    got = t_ffn.fused_mlp_backward(x, w1.to(tdt), b1, w2.to(tdt),
                                   _t(a["dy"]).to(tdt))
    dx, dw1, db1, dw2, db2 = (g.float().numpy() for g in got)
    # the port's weight gradients are in the torch layout
    pairs = zip((dx, dw1.T, db1, dw2.T, db2), want)
    for g, w in pairs:
        w = np.asarray(w, np.float32)
        if dtype == "float32":
            _close(g, w)
        else:
            assert _rel_l2(g, w) < 2e-2


def test_fused_mlp_autograd_on_cpu_equals_the_plain_backward():
    """On the CPU autograd differentiates the plain forward; in fp32 it
    gives kernel 8's plain gradients."""
    a = _mlp_inputs(4)
    args = [t.requires_grad_(True) for t in _port_args(a, torch.float32)]
    out = t_ffn.fused_mlp(*args)
    got = torch.autograd.grad(out, args, _t(a["dy"]))
    want = t_ffn._fused_mlp_backward_reference(*args[:4], _t(a["dy"]))
    for g, w in zip((got[0], got[1], got[2], got[3], got[4]), want):
        _close(g.numpy(), w.detach().numpy())


def test_hidden_width_not_a_multiple_of_8_is_padded_with_zeros():
    a = _mlp_inputs(5, hid=13)
    x, w1, b1, w2, b2 = _port_args(a, torch.bfloat16)
    p1, pb, p2 = t_ffn._pad_hidden(w1, b1, w2)
    assert p1.shape == (16, 128) and pb.shape == (16,) and p2.shape == (128, 16)
    torch.testing.assert_close(t_ffn._fused_mlp_reference(x, p1, pb, p2, b2),
                               t_ffn._fused_mlp_reference(x, w1, b1, w2, b2),
                               rtol=0, atol=0)
    dy = _t(a["dy"]).to(torch.bfloat16)
    full = t_ffn._fused_mlp_backward_reference(x, p1, pb, p2, dy)
    base = t_ffn._fused_mlp_backward_reference(x, w1, b1, w2, dy)
    for g, w in zip((full[0], full[1][:13], full[2][:13], full[3][:, :13],
                     full[4]), base):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert float(full[1][13:].abs().max()) == 0.0


# -- repair 0a: ln_mlp_block's gate is JAX's ------------------------------

class _JaxBlock(jnn.Module):
    dim: int
    dtype: jnp.dtype
    dropout: float

    @jnn.compact
    def __call__(self, x, deterministic):
        return j_layers.ln_mlp_block(
            x, dim=self.dim, hidden_dim=96, dtype=self.dtype,
            norm_name="norm2", mlp_name="mlp", deterministic=deterministic,
            dropout=self.dropout)


class _JaxMlp(jnn.Module):
    dim: int
    dtype: jnp.dtype
    dropout: float

    @jnn.compact
    def __call__(self, x, deterministic):
        return j_layers.Mlp(self.dim, 96, self.dropout, dtype=self.dtype)(
            x, deterministic=deterministic)


def _jax_fuses(module, x_shape, dtype, deterministic, monkeypatch, op):
    """Whether the JAX module calls its fused op, its backend test answered
    as on a TPU (traced only: the spy stands in for the kernel)."""
    calls = []

    def spy(x, *a, **k):
        calls.append(x.shape)
        return x

    monkeypatch.setattr(j_dispatch, "on_tpu", lambda platform=None: True)
    monkeypatch.setattr(j_ffn, op, spy)
    x = jnp.zeros(x_shape, dtype)
    key = jax.random.key(0)
    jax.eval_shape(lambda: module.init({"params": key, "dropout": key}, x,
                                       deterministic))
    monkeypatch.undo()
    return bool(calls)


GRID = [(rows, d, dt, p, det)
        for rows in (8, 12) for d in (64, 128, 768)
        for dt in ("bfloat16", "float32")
        for p, det in ((0.1, True), (0.1, False), (0.0, False))]


@pytest.mark.parametrize("rows,d,dtype,p,det", GRID)
def test_ln_mlp_block_and_mlp_gates_equal_jax(monkeypatch, rows, d, dtype, p,
                                              det):
    shape = (rows, d)
    jdt = jnp.dtype(dtype)
    want_block = _jax_fuses(_JaxBlock(d, jdt, p), shape, jdt, det,
                            monkeypatch, "fused_ln_mlp")
    want_mlp = _jax_fuses(_JaxMlp(d, jdt, p), shape, jdt, det, monkeypatch,
                          "fused_mlp")
    assert want_block == want_mlp  # the same conditions in JAX

    tdt = getattr(torch, dtype)
    x = torch.zeros(shape, dtype=tdt)
    norm, mlp = t_layers.LayerNorm(d), t_layers.Mlp(d, 96, p)
    calls = []
    monkeypatch.setattr(t_layers, "fused_ln_mlp",
                        lambda x, *a, **k: calls.append("ln_mlp") or x)
    monkeypatch.setattr(t_layers, "fused_mlp",
                        lambda x, *a, **k: calls.append("mlp") or x)
    gen = torch.Generator().manual_seed(0)
    t_layers.ln_mlp_block(x, norm, mlp, dropout=p, deterministic=det,
                          generator=gen)
    mlp(x, deterministic=det, generator=gen)
    assert calls == ["ln_mlp", "mlp"] * want_block


def _fake_launches(monkeypatch, *mods):
    """The kernel path without a card: the wrappers take CPU tensors as if
    they were on the card, and each launch records its name and scalar
    arguments (pointers of absent scratch are None)."""
    launched = []
    for mod in mods:
        monkeypatch.setattr(mod, "is_kernel_path", lambda t: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "launch",
                        lambda name, *a: launched.append((name, a)))
    return launched


@pytest.mark.parametrize("d", [128, 256, 384, 512, 640, 768, 1024])
def test_every_gated_ln_mlp_width_reaches_a_kernel(monkeypatch, d):
    """Widths the gate admits, forward and backward; none raises. The
    forward takes its LayerNorm and g scratches and a plan at every width;
    the backward is one pipeline at every width: a plan of five products
    and its yc, G, dH, dy_ln and partial-sum scratches (hidden 96 is not
    staged, and 16 rows are one K slice, never split)."""
    launched = _fake_launches(monkeypatch, t_ffn)
    rs = np.random.RandomState(d)
    x = torch.from_numpy(rs.randn(16, d).astype(np.float32)).bfloat16()
    w1 = torch.zeros(96, d, dtype=torch.bfloat16)
    w2 = torch.zeros(d, 96, dtype=torch.bfloat16)
    vec = torch.zeros(d), torch.zeros(d), torch.zeros(96), torch.zeros(d)
    with torch.no_grad():
        t_ffn.fused_ln_mlp(x, vec[0], vec[1], w1, vec[2], w2, vec[3])
    t_ffn.fused_ln_mlp_backward(x, vec[0], vec[1], w1, vec[2], w2, x)
    (fwd, fa), (bwd, ba) = launched
    assert (fwd, bwd) == ("amt_ln_mlp", "amt_ln_mlp_bwd")
    assert fa[12:15] == (16, d, 96) and ba[21:24] == (16, d, 96)
    assert fa[8] is not None and fa[9] is not None and len(fa[11]) == 42
    assert fa[16] == 0  # fp32 biases
    assert len(ba[0]) == 105  # H, dG, dy_ln, dW1, dW2
    assert all(ba[i] is not None for i in (13, 14, 15, 17, 18, 19))
    assert ba[16] is None and ba[20] is None  # no W2 stage, no split


def test_ln_mlp_wrapper_refuses_an_unaligned_width_on_the_card(monkeypatch):
    _fake_launches(monkeypatch, t_ffn)
    x = torch.zeros(8, 192, dtype=torch.bfloat16)
    w1, w2 = torch.zeros(96, 192).bfloat16(), torch.zeros(192, 96).bfloat16()
    with pytest.raises(ValueError, match="multiple of 128"):
        with torch.no_grad():
            t_ffn.fused_ln_mlp(x, torch.ones(192), torch.zeros(192), w1,
                               torch.zeros(96), w2, torch.zeros(192))


# -- repairs 0b and 0c: every width JAX computes ---------------------------

@pytest.mark.parametrize("width", [4, 8, 12, 16, 32, 48, 64, 100, 256])
def test_nearest_codes_takes_every_code_width(monkeypatch, width):
    rs = np.random.RandomState(width)
    z, codes = rs.randn(24, width), rs.randn(40, width)
    z[5], codes[7] = codes[3], codes[3]  # a tie: the first index wins
    z, codes = z.astype(np.float32), codes.astype(np.float32)
    want = np.asarray(j_cb.nearest_codes(jnp.asarray(z), jnp.asarray(codes)))
    got = t_cb.nearest_codes(torch.from_numpy(z), torch.from_numpy(codes))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[5]) == 3
    launched = _fake_launches(monkeypatch, t_cb)
    t_cb.nearest_codes(torch.from_numpy(z), torch.from_numpy(codes))
    assert [(n, a[5:8]) for n, a in launched] == [
        ("amt_nearest_codes", (24, 40, width))]


@pytest.mark.parametrize("d", [64, 100, 192, 1024, 3072, 4096, 4224, 5000,
                               8192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_takes_every_width(monkeypatch, d, dtype):
    rs = np.random.RandomState(d)
    x = (rs.randn(8, d) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rs.randn(d)).astype(np.float32)
    want = np.asarray(j_ln.layernorm(jnp.asarray(x), jnp.asarray(g)),
                      np.float32)
    got = t_ln.layernorm(torch.from_numpy(x), torch.from_numpy(g))
    _close(got.numpy(), want)
    launched = _fake_launches(monkeypatch, t_ln)
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        t_ln.layernorm(torch.from_numpy(x).to(tdt), torch.from_numpy(g))
    assert [(n, a[4:6]) for n, a in launched] == [("amt_layernorm", (8, d))]
    # the JAX gate's kernel widths are a subset of them
    assert j_ln.layernorm_supported((8, d), platform="tpu") == (d % 128 == 0)


# -- dropout ------------------------------------------------------------------

def _flax_dropout(h, keep, p):
    return jax.lax.select(jnp.asarray(keep), h / (1.0 - p), jnp.zeros_like(h))


def test_mlp_and_ln_mlp_block_dropout_with_given_keep_masks():
    rs = np.random.RandomState(7)
    p, d, hid = 0.25, 64, 96
    x = rs.randn(4, 8, d).astype(np.float32)
    k1, k2 = rs.rand(4, 8, hid) < 1 - p, rs.rand(4, 8, d) < 1 - p
    mlp = t_layers.Mlp(d, hid, p)
    norm = t_layers.LayerNorm(d)
    with torch.no_grad():
        for prm in (*mlp.parameters(), *norm.parameters()):
            prm.copy_(torch.from_numpy(rs.randn(*prm.shape).astype(np.float32)
                                       * 0.2))
    w1, b1 = mlp[0].weight.detach().numpy().T, mlp[0].bias.detach().numpy()
    w2, b2 = mlp[2].weight.detach().numpy().T, mlp[2].bias.detach().numpy()

    def flax_mlp(h):
        h = _flax_dropout(jax.nn.gelu(h @ w1 + b1, approximate=False), k1, p)
        return _flax_dropout(h @ w2 + b2, k2, p)

    keeps = (torch.from_numpy(k1), torch.from_numpy(k2))
    got = mlp(torch.from_numpy(x), deterministic=False, keeps=keeps)
    _close(got.detach().numpy(), flax_mlp(jnp.asarray(x)))
    ln = j_ln._ln_reference(jnp.asarray(x), jnp.asarray(norm.weight.detach()),
                            jnp.asarray(norm.bias.detach()), 1e-5)
    got = t_layers.ln_mlp_block(torch.from_numpy(x), norm, mlp, dropout=p,
                                deterministic=False, keeps=keeps)
    _close(got.detach().numpy(), jnp.asarray(x) + flax_mlp(ln))
    # deterministic: no dropout; a generator draws a seeded mask otherwise
    plain = mlp(torch.from_numpy(x))
    _close(plain.detach().numpy(),
           jax.nn.gelu(x @ w1 + b1, approximate=False) @ w2 + b2)
    draws = [mlp(torch.from_numpy(x), deterministic=False,
                 generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert bool((draws[0] == 0).any())


def test_mlp_keys_are_the_sequentials():
    assert list(t_layers.Mlp(64, 96, 0.1).state_dict()) == [
        "0.weight", "0.bias", "2.weight", "2.bias"]
