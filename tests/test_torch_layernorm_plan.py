"""The LayerNorm kernel (kernel 3, csrc/layernorm.cu) seen from the CPU.

- Its launch through faked launches: the C entry's arguments (rows, width,
  eps, dtype code, gamma and beta as fp32, a null beta), one launch a call
  on the direct and the autograd paths, every width reaching the kernel.
- A numpy-seeded emulation of the order the kernel keeps (each lane sums
  its 16-byte pieces lane + 32c in column order, warp_sum's butterfly, the
  two-pass statistics with an FMA a centred square, then
  (v - mean) * rstd * gamma (+ beta)) at d 192, 512, 768, 1024 and 4096,
  within 1e-6 of the port's ``_ln_reference`` in fp32 and of JAX's.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_models_torch.ops import _build
from attention_models_torch.ops import layernorm as t_ln
from attention_models_tpu.ops import layernorm as j_ln

TOL = 1e-6


def _fake_launches(monkeypatch):
    launched = []
    monkeypatch.setattr(t_ln, "is_kernel_path", lambda t: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "launch",
                        lambda name, *a: launched.append((name, a)))
    return launched


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_beta", [True, False])
def test_launch_arguments(monkeypatch, dtype, with_beta):
    launched = _fake_launches(monkeypatch)
    x = torch.zeros(2, 8, 512, dtype=dtype)
    g = torch.ones(512, dtype=torch.bfloat16)
    b = torch.zeros(512) if with_beta else None
    y = t_ln.layernorm(x, g, b)
    ((name, args),) = launched
    assert name == "amt_layernorm"
    assert args[0] == x.data_ptr() and args[3] == y.data_ptr()
    assert (args[2] is None) == (not with_beta)
    assert args[4:8] == (16, 512, 1e-5, _build.DTYPE_CODES[dtype])
    assert y.shape == x.shape and y.dtype == dtype


def test_one_launch_a_call(monkeypatch):
    launched = _fake_launches(monkeypatch)
    before = t_ln.layernorm.launches
    x = torch.zeros(64, 768)
    t_ln.layernorm(x, torch.ones(768))
    assert t_ln.layernorm.launches == before + 1
    # the autograd path: the kernel is the Function's forward, one launch
    t_ln.layernorm(x.requires_grad_(True), torch.ones(768))
    assert t_ln.layernorm.launches == before + 2
    assert [n for n, _ in launched] == ["amt_layernorm"] * 2


@pytest.mark.parametrize("d", [100, 192, 768, 4096, 8192])
def test_every_width_reaches_the_kernel(monkeypatch, d):
    launched = _fake_launches(monkeypatch)
    t_ln.layernorm(torch.zeros(24, d, dtype=torch.bfloat16), torch.ones(d))
    ((name, args),) = launched
    assert args[5] == d


def _lane_order(x, gamma, beta, eps, vec):
    """The kernel's arithmetic on fp32 rows: lane l's values are the pieces
    l + 32c of ``vec`` elements, summed in column order; the lanes' sums
    combine by warp_sum's butterfly (xor 16, 8, 4, 2, 1)."""
    n, d = x.shape
    nvec = d // vec
    nchunk = -(-nvec // 32)
    per_lane = nchunk * vec
    cols = torch.zeros(32, per_lane, dtype=torch.long)
    live = torch.zeros(32, per_lane, dtype=torch.bool)
    for lane in range(32):
        for c in range(nchunk):
            i = lane + 32 * c
            for j in range(vec):
                if i < nvec:
                    cols[lane, c * vec + j] = i * vec + j
                    live[lane, c * vec + j] = True
    lanes = torch.arange(32)

    def butterfly(s):
        for o in (16, 8, 4, 2, 1):
            s = s + s[:, lanes ^ o]
        return s[:, 0]

    s = torch.zeros(n, 32)
    for p in range(per_lane):
        s = s + torch.where(live[:, p], x[:, cols[:, p]], torch.zeros(()))
    mean = (butterfly(s) / d)[:, None]
    sq = torch.zeros(n, 32)
    for p in range(per_lane):
        t = x[:, cols[:, p]] - mean
        fma = (t.double() * t.double() + sq.double()).float()
        sq = torch.where(live[:, p], fma, sq)
    rstd = torch.rsqrt(butterfly(sq) / d + eps)[:, None]
    y = (x - mean) * rstd * gamma
    return y + beta if beta is not None else y


@pytest.mark.parametrize("d", [192, 512, 768, 1024, 4096])
@pytest.mark.parametrize("vec", [4, 8])
def test_the_lane_order_matches_the_plain_versions(d, vec):
    """vec 4: fp32 rows (4 a 16-byte piece); vec 8: the bf16 rows' pieces
    (their values in fp32)."""
    rs = np.random.RandomState(d + vec)
    x = (rs.randn(24, d) * 2.0 + 0.5).astype(np.float32)
    if vec == 8:
        x = torch.from_numpy(x).bfloat16().float().numpy()
    g = (1.0 + 0.1 * rs.randn(d)).astype(np.float32)
    b = (0.1 * rs.randn(d)).astype(np.float32)
    for beta in (b, None):
        tb = None if beta is None else torch.from_numpy(beta)
        got = _lane_order(torch.from_numpy(x), torch.from_numpy(g), tb, 1e-5,
                          vec)
        want = t_ln._ln_reference(torch.from_numpy(x), torch.from_numpy(g),
                                  tb, 1e-5)
        jwant = j_ln._ln_reference(jnp.array(x), jnp.array(g),
                                   None if beta is None else jnp.array(beta),
                                   1e-5)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=TOL,
                                   rtol=0)
