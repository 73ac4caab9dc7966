"""The port's sampling ops (attention_models_torch/ops/sampling.py) against
the JAX package's, on the CPU, fed the same numpy-made logits and noise.

Tolerances: integer results (ids, masks, kept sets) exactly equal;
``kth_value_bisect`` bit-equal (the same fp32 operations in the same
order); the fused epilogue's plain version against the JAX kernel in
interpret mode on equal bits: ``pred`` equal, score within rtol 1e-5
(exp/log in two libraries), at C 256 and at C 16384 (a row wider than the
8192 values the kernel holds in registers, which it walks in chunks);
Philox against the Random123 known-answer vectors, bit-equal. The
kernel's threshold search (whole-row counts until few values lie in the
interval, then those values alone, gathered a warp at a time,
csrc/sampling.cu) is modelled in numpy
and held bit-equal to ``kth_value_bisect`` on ties, constant rows, k = 1
and k = C, collapsing ranges and negative rows; a faked launch shows C
16384 reaching the kernel's entry at its full width.
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from attention_models_torch.ops import _build
from attention_models_torch.ops import sampling as ts
from attention_models_tpu.ops import sampling as js


def _t(a):
    return torch.from_numpy(np.array(a))


def test_cosine_schedule_matches_jax():
    t = np.linspace(0, 1, 7, dtype=np.float32)
    np.testing.assert_allclose(ts.cosine_schedule(_t(t)).numpy(),
                               np.asarray(js.cosine_schedule(jnp.array(t))),
                               atol=1e-7)


@pytest.mark.parametrize("approx", [False, True])
def test_filter_logits_matches_jax(approx):
    logits = np.random.RandomState(0).randn(2, 5, 100).astype(np.float32)
    got = ts.filter_logits(_t(logits), 0.9, approx=approx).numpy()
    want = np.asarray(js.filter_logits(jnp.array(logits), 0.9, approx=approx))
    np.testing.assert_array_equal(got, want)


def test_filter_logits_exact_ties_keep_lowest_index_like_top_k():
    """A coarse grid ties many values at the k-th: exactly k survive, the
    lowest indices among the tied ones, as lax.top_k keeps them."""
    rs = np.random.RandomState(7)
    logits = (np.round(rs.randn(2, 5, 40) * 2) / 2).astype(np.float32)
    got = ts.filter_logits(_t(logits), 0.9).numpy()
    want = np.asarray(js.filter_logits(jnp.array(logits), 0.9))
    np.testing.assert_array_equal(np.isfinite(got).sum(-1),
                                  np.full((2, 5), math.ceil(0.1 * 40)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kth_value_bisect_bit_equal(dtype):
    x = np.random.RandomState(1).randn(3, 7, 256).astype(np.float32)
    xt = _t(x).to(getattr(torch, dtype))
    xj = jnp.array(x).astype(getattr(jnp, dtype))
    for k in (1, 26, 255):
        np.testing.assert_array_equal(
            ts.kth_value_bisect(xt, k).numpy(),
            np.asarray(js.kth_value_bisect(xj, k)))


def test_gumbel_argmax_matches_jax_on_its_noise():
    key = jax.random.key(4)
    logits = np.random.RandomState(2).randn(4, 6, 50).astype(np.float32)
    noise = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))
    got = ts.gumbel_argmax(_t(logits), 0.7, noise=_t(noise)).numpy()
    want = np.asarray(js.gumbel_argmax(key, jnp.array(logits), 0.7))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("approx", [False, True])
def test_sample_topk_filtered_matches_jax_on_its_noise(approx):
    key = jax.random.key(5)
    logits = np.random.RandomState(3).randn(2, 8, 120).astype(np.float32)
    k = math.ceil(0.1 * 120)
    shape = logits.shape if approx else logits.shape[:-1] + (k,)
    noise = np.asarray(jax.random.gumbel(key, shape, jnp.float32))
    pred, chosen = ts.sample_topk_filtered(_t(logits), 0.9, 0.8,
                                           approx=approx, noise=_t(noise))
    pj, cj = js.sample_topk_filtered(key, jnp.array(logits), 0.9, 0.8,
                                     approx=approx)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(chosen.numpy(), np.asarray(cj))


def test_lowest_score_mask_with_ties_matches_jax():
    rs = np.random.RandomState(8)
    scores = (rs.randint(0, 4, (3, 20)) / 4).astype(np.float32)  # many ties
    scores[0] = 1.0                                             # all tied
    for num in (1, 7, 20):
        np.testing.assert_array_equal(
            ts.lowest_score_mask(_t(scores), num).numpy(),
            np.asarray(js.lowest_score_mask(jnp.array(scores), num)))


def test_mask_fill_inputs_and_targets_matches_jax():
    rs = np.random.RandomState(9)
    idx = rs.randint(0, 64, (2, 16)).astype(np.int32)
    mask = rs.rand(2, 16) < 0.5
    got = ts.mask_fill_inputs_and_targets(_t(idx), _t(mask), 64)
    want = js.mask_fill_inputs_and_targets(jnp.array(idx), jnp.array(mask), 64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    long = lambda v: torch.tensor(v, dtype=torch.long)  # noqa: E731
    got = ts.philox4x32_10(tuple(map(long, ctr)), tuple(map(long, key)))
    assert tuple(int(w) for w in got) == want


def test_philox_bits_depend_on_seed_step_and_position_only():
    bits = ts.philox_bits(torch.tensor([11, 12, 13]), 5, 2, 40)
    assert bits.shape == (15, 40) and bits.dtype == torch.int32
    alone = ts.philox_bits(torch.tensor([12]), 5, 2, 40)
    assert torch.equal(bits[5:10], alone)
    other_step = ts.philox_bits(torch.tensor([12]), 5, 3, 40)
    assert not torch.equal(alone, other_step)
    assert len(set(bits.flatten().tolist())) == bits.numel()  # no repeats


def _epilogue_case(seed, shape, with_null):
    rs = np.random.RandomState(seed)
    cond = rs.randn(*shape).astype(np.float32)
    null = rs.randn(*shape).astype(np.float32) if with_null else None
    bits = rs.randint(-(2 ** 31), 2 ** 31 - 1, shape).astype(np.int32)
    return cond, null, bits


@pytest.mark.parametrize("with_null,temp,shape", [
    pytest.param(True, 0.35, (2, 16, 256), id="True-0.35"),
    pytest.param(False, 0.35, (2, 16, 256), id="False-0.35"),
    pytest.param(False, 0.0, (2, 16, 256), id="False-0.0"),
    pytest.param(False, 0.35, (1, 16, 16384), id="False-0.35-C16384"),
])
def test_epilogue_plain_matches_jax_kernel_in_interpret_mode(with_null, temp,
                                                              shape):
    cond, null, bits = _epilogue_case(5, shape, with_null)
    with pltpu.force_tpu_interpret_mode():
        pj, sj = js.sample_epilogue_fused(
            jax.random.key(0), jnp.array(cond),
            None if null is None else jnp.array(null), guidance_scale=3.0,
            p=0.9, temperature=temp, interpret=True,
            _noise_bits=jnp.array(bits))
    before = ts.sample_epilogue_fused.launches
    pt, st = ts.sample_epilogue_fused(
        _t(cond), None if null is None else _t(null), guidance_scale=3.0,
        p=0.9, temperature=temp, noise_bits=_t(bits))
    assert ts.sample_epilogue_fused.launches == before  # CPU: plain version
    assert pt.shape == shape[:2] and pt.dtype == torch.int32
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5, atol=0)


def test_epilogue_picks_lie_in_the_kept_set_and_follow_the_seeds():
    cond, _, _ = _epilogue_case(6, (3, 4, 128), False)
    x = _t(cond)
    pred, score = ts.sample_epilogue_fused(x, temperature=1.0,
                                           seeds=torch.tensor([1, 2, 3]), step=4)
    kth = ts.kth_value_bisect(x, math.ceil(0.1 * 128))
    picked = x.gather(-1, pred.long()[..., None])[..., 0]
    assert bool((picked >= kth).all()) and bool((score > 0).all())
    alone, _ = ts.sample_epilogue_fused(x[1:2], temperature=1.0,
                                        seeds=torch.tensor([2]), step=4)
    assert torch.equal(alone[0], pred[1])
    with pytest.raises(ValueError, match="seeds"):
        ts.sample_epilogue_fused(x, temperature=1.0, seeds=torch.tensor([1]))


def test_rows_wider_than_8192_reach_the_kernel(monkeypatch):
    """C 16384 (a codebook wider than the 8192 values a block holds in
    registers, which JAX's gate takes) reaches the kernel's entry with its
    full width and k, in both dtypes."""
    launched = []
    monkeypatch.setattr(ts, "is_kernel_path", lambda t: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "launch",
                        lambda name, *a: launched.append((name, a)))
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.zeros(2, 8, 16384, dtype=dtype)
        pred, score = ts.sample_epilogue_fused(
            x, x, guidance_scale=3.0, temperature=1.0,
            seeds=torch.tensor([1, 2]), step=3)
        assert pred.shape == score.shape == (2, 8)
    assert len(launched) == 2
    for (name, args), dtype in zip(launched, (torch.bfloat16, torch.float32)):
        assert name == "amt_sample_epilogue"
        # rows_per_seed, step; rows, C, k, iters, gs, temperature, dtype
        assert args[4:6] == (8, 3)
        assert args[8:14] == (16, 16384, math.ceil(0.1 * 16384), 16, 3.0, 1.0)
        assert args[14] == _build.DTYPE_CODES[dtype]


# -- the kernel's threshold search, modelled in numpy -------------------------

PER_WARP = 128  # csrc/sampling.cu kPerWarp (8 warps: kCap 1024)


def _mid(lo, hi):
    return np.float32(0.5) * np.float32(lo + hi)


def _warp_of(C):
    """The warp of each column: thread (c / 4) % 256 holds it, 32 a warp."""
    return (np.arange(C) // 4 % 256) // 32


def _kernel_search(x, k, iters=16, per_warp=PER_WARP):
    """csrc/sampling.cu's threshold for one fp32 row: whole-row counting
    levels until at most 8 * ``per_warp`` values lie in [lo, hi) (count(x >=
    lo) - count(x >= hi) from the counts taken, count(x >= max) taken as 0
    while hi is the max) and no warp holds more than ``per_warp`` of them;
    then the remaining levels on those values alone (all of [lo, max] while
    hi is the max), count(x >= mid) = count(x >= hi) + those >= mid.
    Returns (threshold, whole-row levels, values gathered)."""
    lo, hi = x.min(), x.max()
    warp = _warp_of(x.size)
    cnt_lo, cnt_hi, hi_moved, cand = x.size, 0, False, None
    levels = 0
    for _ in range(iters):
        if cand is None and cnt_lo - cnt_hi <= 8 * per_warp:
            take = (x >= lo) & (x < (hi if hi_moved else np.float32(np.inf)))
            if np.bincount(warp[take], minlength=8).max() <= per_warp:
                cand, base = x[take], (cnt_hi if hi_moved else 0)
        mid = _mid(lo, hi)
        if cand is None:
            cnt = int((x >= mid).sum())
            levels += 1
        else:
            cnt = base + int((cand >= mid).sum())
        if cnt >= k:
            lo, cnt_lo = mid, cnt
        else:
            hi, cnt_hi, hi_moved = mid, cnt, True
    return lo, levels, 0 if cand is None else cand.size


def _search_rows():
    rs = np.random.RandomState(11)
    one = np.float32(1.0)
    rows = {
        "normal": (rs.randn(512) * 3).astype(np.float32),
        "bf16 grid": torch.tensor(rs.randn(512) * 3).to(torch.bfloat16)
        .float().numpy(),
        "ties at the k-th": np.repeat(np.arange(16, dtype=np.float32), 32),
        "constant": np.full(256, 0.75, np.float32),
        "negative only": -np.abs(rs.randn(384) * 1e3).astype(np.float32) - 5,
        "two adjacent floats": np.where(rs.rand(256) < 0.3, one,
                                        np.nextafter(one, np.float32(2))),
        "a few ulps": one + np.float32(2 ** -23) * rs.randint(0, 6, 256)
        .astype(np.float32),
        "one outlier": np.append(np.zeros(255, np.float32), np.float32(1e30)),
        "subnormals": rs.randint(0, 9, 256).astype(np.float32)
        * np.float32(1e-45),
    }
    return rows


@pytest.mark.parametrize("per_warp", [PER_WARP, 2])
@pytest.mark.parametrize("name", list(_search_rows()))
def test_kernel_search_is_the_bisection_bit_for_bit(name, per_warp):
    """The kernel's search gives ``kth_value_bisect``'s threshold bit for
    bit, at k = 1, the top-p k, C / 2 and k = C, at iters 16, 12 and 3, with
    its capacity (these rows are gathered whole) and with 2 values a warp
    (some whole-row levels first)."""
    x = _search_rows()[name]
    C = x.size
    for k in sorted({1, math.ceil(0.1 * C), C // 2, C}):
        for iters in (16, 12, 3):
            want = ts.kth_value_bisect(torch.from_numpy(x)[None], k,
                                       iters).numpy()[0]
            got, _, _ = _kernel_search(x, k, iters, per_warp)
            assert got.tobytes() == np.float32(want).tobytes(), (k, iters)


def test_whole_row_levels_leave_few_values_at_the_decode_shape():
    """At the decode shape (8192 logits of scale 3, k = 820) three
    whole-row levels leave the warps some 850 values, and the threshold is
    the bisection's."""
    x = (np.random.RandomState(3).randn(8192) * 3).astype(np.float32)
    k = math.ceil(0.1 * 8192)
    got, levels, kept = _kernel_search(x, k)
    want = ts.kth_value_bisect(torch.from_numpy(x)[None], k).numpy()[0]
    assert got == want
    assert levels == 3 and 0 < kept <= 8 * PER_WARP
