"""The nearest-code argmin (kernel 4, csrc/codebook.cu) seen from the CPU.

- Its launch through faked launches: the C entry's arguments for bf16 and
  fp32 at widths 8, 16, 20, 32, 40 and 64 (the design each width goes to,
  the slice of codes and the slice count) and the scratches the wrapper
  allocates (the slices' pairs, the token tiles' tickets, |e|^2 and the
  transposed fp32 codebook); the block counts the plan assumes are the
  kernels' own.
- A numpy emulation of the kernel's reduction: each thread walks its
  columns in ascending order with a strict '<' (bf16: a chain per row and
  column parity, the quad combined by shuffles xor 1, 2; fp32: a chain per
  row, the 16 threads of a tile row by xor 1 .. 8) under the lexicographic
  (dist, index) minimum, then the slices in order with a strict '<'. Held
  against ``_nearest_codes_reference`` and JAX's ``_nearest_codes_xla``
  with exact equality, with duplicate codes placed so that ties cross a
  quad lane, a 128-code chunk and a slice boundary, and -0.0 against +0.0.
- A numpy emulation of the fp32 dot and |e|^2 orders: the parent kernel's
  (fmaf over the width in ascending order from 0; lanes over the dims,
  then warp_sum's butterfly) and the register tiles' (thread (tx, ty)'s 8 x
  8 accumulators, each fmaf over the width in ascending order) give the
  same bits, and their indices meet the plain version's.
"""

import contextlib
import fractions
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_models_torch.ops import _build
from attention_models_torch.ops import codebook as t_cb
from attention_models_tpu.ops import codebook as j_cb

N, K = 8192, 8192  # the main path's tokens and codes (vitvqgan_base)


def _fake_launches(monkeypatch):
    launched, allocated = [], []
    monkeypatch.setattr(t_cb, "is_kernel_path", lambda t: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "launch",
                        lambda name, *a: launched.append((name, a)))
    empty = torch.empty

    def record(n, **kw):
        allocated.append((n, kw["dtype"]))
        return empty(n, **kw)

    monkeypatch.setattr(t_cb.torch, "empty", record)
    return launched, allocated


# (dtype, width) -> (design, codes a slice, slices) at 8192 tokens x 8192
# codes: bf16 on wgmma and fp32 tiles two blocks an SM (4 slices: 256
# blocks, one wave), other widths the first design's 512-code slices
ROUTES = {
    (torch.bfloat16, 8): (t_cb.WGMMA, 2048, 4),
    (torch.bfloat16, 16): (t_cb.WGMMA, 2048, 4),
    (torch.bfloat16, 20): (t_cb.ANY, 512, 16),
    (torch.bfloat16, 32): (t_cb.WGMMA, 2048, 4),
    (torch.bfloat16, 40): (t_cb.ANY, 512, 16),
    (torch.bfloat16, 64): (t_cb.WGMMA, 2048, 4),
    (torch.float32, 8): (t_cb.TILES, 2048, 4),
    (torch.float32, 16): (t_cb.TILES, 2048, 4),
    (torch.float32, 20): (t_cb.ANY, 512, 16),
    (torch.float32, 32): (t_cb.TILES, 2048, 4),
    (torch.float32, 40): (t_cb.ANY, 512, 16),
    (torch.float32, 64): (t_cb.TILES, 2048, 4),
}


@pytest.mark.parametrize("dtype,width", list(ROUTES))
def test_launch_arguments(monkeypatch, dtype, width):
    launched, allocated = _fake_launches(monkeypatch)
    z = torch.zeros(N, width, dtype=dtype)
    codes = torch.zeros(K, width, dtype=dtype)
    before = t_cb.nearest_codes.launches
    out = t_cb.nearest_codes(z, codes)
    design, split, slices = ROUTES[dtype, width]
    ((name, args),) = launched
    assert name == "amt_nearest_codes"
    assert args[0] == z.data_ptr() and args[1] == codes.data_ptr()
    assert args[4] == out.data_ptr()
    assert args[5:10] == (N, K, width, split, _build.DTYPE_CODES[dtype])
    assert len(args) == 12 and t_cb.codes_plan(N, K, width, dtype).design \
        == design
    assert split % t_cb.CHUNK == 0 and -(-K // split) == slices
    parts = N * slices
    # |e|^2, a ticket a 128-token tile, the transposed fp32 codebook
    work = 0 if design == t_cb.ANY else K + N // 128 + (
        K * width if design == t_cb.TILES else 0)
    assert allocated == [(parts, torch.float32), (parts, torch.int32),
                         (work, torch.float32), (N, torch.int32)]
    assert out.shape == (N,) and out.dtype == torch.int32
    assert t_cb.nearest_codes.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,k,d,slices", [
    (24, 40, 32, 1),        # one slice: the argmin writes the indices
    (520, 1000, 16, None),  # ragged tokens, a ragged last chunk
    (8192, 77, 8, 1),       # fewer codes than a chunk
    (8192, 8256, 64, None),  # a 65th chunk
    (8192, 8192, 32, None),  # the main path's
])
def test_plan_slices_and_scratch(dtype, n, k, d, slices):
    plan = t_cb.codes_plan(n, k, d, dtype)
    assert plan.design == (t_cb.WGMMA if dtype == torch.bfloat16
                           else t_cb.TILES)
    assert plan.split % t_cb.CHUNK == 0 and plan.split >= t_cb.CHUNK
    assert plan.slices == -(-k // plan.split)
    assert (plan.slices - 1) * plan.split < k <= plan.slices * plan.split
    if slices is not None:
        assert plan.slices == slices
    assert plan.parts == (n * plan.slices if plan.slices > 1 else 0)
    ldt, tickets = -(-k // 4) * 4, -(-n // 512) * 4
    assert plan.work == ldt * (1 + (d if dtype == torch.float32 else 0)) + (
        tickets)
    # no slice count costs fewer waves x (chunks a slice + 1)
    slots = t_cb.SM_COUNT * t_cb.BLOCKS_PER_SM
    best = t_cb.slice_cost(n, k, slots, plan.slices)
    assert all(best <= t_cb.slice_cost(n, k, slots, s)
               for s in range(1, -(-k // 128) + 1))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,k,slices", [(100, 77, 1), (520, 1000, 2),
                                        (8192, 8192, 16)])
def test_plan_of_other_widths(dtype, n, k, slices):
    """Width 20 on the first design: 512-code slices, each slice's pairs
    (one slice too) combined by a second launch; no work scratch."""
    plan = t_cb.codes_plan(n, k, 20, dtype)
    assert (plan.design, plan.split, plan.slices) == (t_cb.ANY, 512, slices)
    assert plan.parts == n * slices and plan.work == 0


def test_plan_blocks_and_widths_are_the_kernels():
    """BLOCKS_PER_SM and NEW_WIDTHS are what csrc/codebook.cu launches."""
    src = (Path(t_cb.__file__).resolve().parents[1] / "csrc"
           / "codebook.cu").read_text()
    for name in ("kWgBlocks", "kTileBlocks"):
        (value,) = re.findall(rf"constexpr int {name} = (\d+);", src)
        assert int(value) == t_cb.BLOCKS_PER_SM, name
    assert "__launch_bounds__(kWgThreads, kWgBlocks)" in src
    assert "__launch_bounds__(kTileThreads, kTileBlocks)" in src
    (test,) = re.findall(r"if \((d != \d+(?: && d != \d+)*)\) return kAny;",
                         src)
    assert tuple(int(w) for w in re.findall(r"\d+", test)) == t_cb.NEW_WIDTHS


def test_misaligned_views_are_copied(monkeypatch):
    launched, _ = _fake_launches(monkeypatch)
    base = torch.zeros(64 * 32 + 2, dtype=torch.bfloat16)
    z = base[2:].view(64, 32)  # 4 bytes past a 16-byte boundary
    codes = torch.zeros(256, 32, dtype=torch.bfloat16)
    t_cb.nearest_codes(z, codes)
    ((_, args),) = launched
    assert args[0] % 16 == 0 and args[0] != z.data_ptr()


# -- the reduction -------------------------------------------------------------

def _lex_take(d, i, od, oi):
    """Where (od, oi) comes first in the lexicographic (dist, index) order."""
    return (od < d) | ((od == d) & (oi < i))


def _butterfly(d, i, span):
    """__shfl_xor over ``span`` lanes (axis 1), lexicographic minimum."""
    lanes = np.arange(span)
    o = 1
    while o < span:
        od, oi = d[:, lanes ^ o], i[:, lanes ^ o]
        take = _lex_take(d, i, od, oi)
        d, i = np.where(take, od, d), np.where(take, oi, i)
        o <<= 1
    return d[:, 0], i[:, 0]


def _slice_pairs(dist, c0, c1, design):
    """One block's (min, argmin) per row of its slice [c0, c1)."""
    n = dist.shape[0]
    if design == t_cb.WGMMA:
        lanes, chains = 4, 2  # quad lane t, column parity e: column 2t + e mod 8
    else:
        lanes, chains = 16, 1  # tx: columns 4 tx .. +3 and 64 + 4 tx .. +3
    best = np.full((n, lanes, chains), np.inf, np.float32)
    idx = np.full((n, lanes, chains), c0, np.int64)
    for col in range(c0, c1):
        local = (col - c0) % t_cb.CHUNK
        if design == t_cb.WGMMA:
            lane, ch = (local % 8) // 2, local % 2
        else:
            lane, ch = (local % 64) // 4, 0
        v = dist[:, col]
        upd = v < best[:, lane, ch]  # strict: the first lowest of the chain
        best[upd, lane, ch] = v[upd]
        idx[upd, lane, ch] = col
    d, i = best[:, :, 0], idx[:, :, 0]
    for ch in range(1, chains):  # the thread's chains of a row
        take = _lex_take(d, i, best[:, :, ch], idx[:, :, ch])
        d = np.where(take, best[:, :, ch], d)
        i = np.where(take, idx[:, :, ch], i)
    return _butterfly(d, i, lanes)


def emulate(dist, split, design):
    """The kernel's indices for a distance matrix: blocks' pairs per slice,
    then the slices in ascending order with a strict '<' (combine_last)."""
    n, k = dist.shape
    best, idx = None, None
    for c0 in range(0, k, split):
        d, i = _slice_pairs(dist, c0, min(k, c0 + split), design)
        if best is None:
            best, idx = d, i
        else:
            upd = d < best
            best, idx = np.where(upd, d, best), np.where(upd, i, idx)
    return idx.astype(np.int32)


def _ties(d, k, rs):
    """Small-integer codes (every dot exact in any order) and tokens equal
    to chosen codes, whose duplicates sit across a quad lane (2t + e of
    another t), a 128-code chunk and a 256-code slice, the first lowest
    before them."""
    codes = rs.randint(-3, 4, size=(k, d)).astype(np.float32) / 4
    z = rs.randint(-3, 4, size=(24, d)).astype(np.float32) / 4
    pairs = [(3, 5), (9, 14), (100, 200), (130, 250), (10, 266), (251, 300),
             (7, 15), (40, 520), (255, 256), (127, 128)]
    for row, (a, b) in enumerate(pairs):
        codes[b] = codes[a]
        z[row] = codes[a]
    return z, codes, pairs


@pytest.mark.parametrize("design", [t_cb.WGMMA, t_cb.TILES])
@pytest.mark.parametrize("d", [8, 32])
def test_reduction_ties_match_plain_and_jax(design, d):
    rs = np.random.RandomState(d + 10 * design)
    z, codes, pairs = _ties(d, 600, rs)
    zt, ct = torch.from_numpy(z), torch.from_numpy(codes)
    dist = (torch.sum(ct * ct, -1)[None] - 2.0 * (zt @ ct.T)).numpy()
    got = emulate(dist, 256, design)
    want = t_cb._nearest_codes_reference(zt, ct).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(j_cb._nearest_codes_xla(jnp.asarray(z),
                                                jnp.asarray(codes))))
    for row, (a, _) in enumerate(pairs):
        assert got[row] == a


@pytest.mark.parametrize("design", [t_cb.WGMMA, t_cb.TILES])
def test_reduction_signed_zeros_are_equal(design):
    """-0.0 and +0.0 compare equal under '<' and in the lexicographic
    combine, so the lower index wins whichever sign it has."""
    n, k = 6, 600
    dist = np.full((n, k), 1.0, np.float32)
    cases = [(3, 5, 0.0, -0.0), (3, 5, -0.0, 0.0), (100, 200, 0.0, -0.0),
             (10, 266, -0.0, 0.0), (255, 256, 0.0, -0.0),
             (2, 10, -0.0, -0.0)]
    for row, (a, b, va, vb) in enumerate(cases):
        dist[row, a], dist[row, b] = va, vb
    got = emulate(dist, 256, design)
    np.testing.assert_array_equal(got, [a for a, *_ in cases])
    np.testing.assert_array_equal(
        got, torch.argmin(torch.from_numpy(dist), dim=1).numpy())


@pytest.mark.parametrize("design", [t_cb.WGMMA, t_cb.TILES])
@pytest.mark.parametrize("split", [128, 256, 512])
def test_reduction_matches_plain_on_random_codes(design, split):
    rs = np.random.RandomState(split + design)
    z = rs.randn(40, 16).astype(np.float32)
    codes = rs.randn(700, 16).astype(np.float32)
    zt, ct = torch.from_numpy(z), torch.from_numpy(codes)
    dist = (torch.sum(ct * ct, -1)[None] - 2.0 * (zt @ ct.T)).numpy()
    np.testing.assert_array_equal(
        emulate(dist, split, design),
        t_cb._nearest_codes_reference(zt, ct).numpy())


# -- the fp32 orders -----------------------------------------------------------

def fma32(a, b, c):
    """fmaf: a * b + c rounded once to float32 (float32 arrays). The product
    is exact in float64; TwoSum gives the sum's rounding error, which
    decides only a sum that lands on a float32 midpoint."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = np.asarray(c, np.float64)
    s = p + c64
    bb = s - p
    t = (p - (s - bb)) + (c64 - bb)
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    toward = np.where(s > r64, np.float32(np.inf), np.float32(-np.inf))
    other = np.nextafter(r, toward.astype(np.float32))
    mid = (s != r64) & (np.abs(s - r64) * 2 == np.abs(other.astype(np.float64)
                                                      - r64))
    lo, hi = np.minimum(r, other), np.maximum(r, other)
    fixed = np.where(t > 0, hi, np.where(t < 0, lo, r))
    return np.where(mid, fixed, r).astype(np.float32)


def _round32(x: fractions.Fraction) -> np.float32:
    """x rounded to the nearest float32, ties to even, exactly."""
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    errs = [abs(fractions.Fraction(float(c)) - x) for c in cands]
    best = min(errs)
    near = [c for c, e in zip(cands, errs) if e == best]
    return min(near, key=lambda c: int(np.float32(c).view(np.uint32)) & 1)


def test_fma32_rounds_once():
    rs = np.random.RandomState(0)
    a = rs.randn(4000).astype(np.float32)
    b = rs.randn(4000).astype(np.float32)
    c = (rs.randn(4000) * 10.0 ** rs.randint(-8, 3, 4000)).astype(np.float32)
    # sums on a float32 midpoint: exact ties (ties to even) ...
    steps = np.arange(500, dtype=np.float32) * np.float32(2.0 ** -23)
    a[:500], b[:500] = np.float32(1.0), np.float32(2.0 ** -24)
    c[:500] = np.float32(1.0) + steps
    # ... and a float64 sum rounded onto a midpoint from below (the product
    # 2^-24 - 2^-70 past the float64 bits of c): TwoSum's error decides
    a[500:1000] = np.float32(1.0 + 2.0 ** -23)
    b[500:1000] = np.float32(2.0 ** -24 - 2.0 ** -47)
    c[500:1000] = np.float32(1.0) + steps
    got = fma32(a, b, c)
    for i in range(len(a)):
        x = (fractions.Fraction(float(a[i])) * fractions.Fraction(float(b[i]))
             + fractions.Fraction(float(c[i])))
        assert got[i] == _round32(x), i


def parent_dots(z, e):
    """The parent kernel's dot: fmaf(z_c, e_c, dot) over c ascending from 0."""
    acc = np.zeros((z.shape[0], e.shape[0]), np.float32)
    for c in range(z.shape[1]):
        acc = fma32(z[:, c, None], e[None, :, c], acc)
    return acc


def tile_dots(z, e):
    """The register tiles' dots: per 128-token x 128-code tile, thread (tx,
    ty)'s accumulators acc[r][j] (rows 4 ty + r, 60 + 4 ty + r; columns
    4 tx + j, 60 + 4 tx + j), each fmaf(a[r], b[j], acc) over the width in
    ascending order from 0. Every (row, code) pair is one thread's."""
    n, d = z.shape
    k = e.shape[0]
    out = np.full((n, k), np.nan, np.float32)
    owners = np.zeros((n, k), np.int64)
    rows_of = [np.r_[4 * ty:4 * ty + 4, 64 + 4 * ty:68 + 4 * ty]
               for ty in range(16)]
    cols_of = [np.r_[4 * tx:4 * tx + 4, 64 + 4 * tx:68 + 4 * tx]
               for tx in range(16)]
    for m0 in range(0, n, 128):
        for c0 in range(0, k, 128):
            for ty in range(16):
                rows = m0 + rows_of[ty]
                rows = rows[rows < n]
                for tx in range(16):
                    cols = c0 + cols_of[tx]
                    cols = cols[cols < k]
                    acc = np.zeros((len(rows), len(cols)), np.float32)
                    for c in range(d):
                        acc = fma32(z[rows, c][:, None], e[cols, c][None], acc)
                    out[np.ix_(rows, cols)] = acc
                    owners[np.ix_(rows, cols)] += 1
    assert (owners == 1).all()
    return out


def lane_esq(e):
    """|e|^2 as the parent kernel and the prep pass take it: lane l sums
    the dims l, l + 32 by fmaf from 0, then warp_sum's butterfly (xor 16,
    8, 4, 2, 1) in float32."""
    k, d = e.shape
    s = np.zeros((k, 32), np.float32)
    for lane in range(32):
        for c in range(lane, d, 32):
            s[:, lane] = fma32(e[:, c], e[:, c], s[:, lane])
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        s = (s + s[:, lanes ^ o]).astype(np.float32)
    return s[:, 0]


@pytest.mark.parametrize("d", [8, 16, 32, 64])
def test_fp32_orders_keep_the_parents_bits(d):
    rs = np.random.RandomState(d)
    z = rs.randn(130, d).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    e = rs.randn(200, d).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    z, e = z.astype(np.float32), e.astype(np.float32)
    dots = parent_dots(z, e)
    np.testing.assert_array_equal(tile_dots(z, e), dots)
    esq = lane_esq(e)
    dist = (esq[None] - np.float32(2.0) * dots).astype(np.float32)
    # the parent's one-thread kernel: (min, argmin) over the codes in order
    want = emulate(dist, 512, t_cb.TILES)
    np.testing.assert_array_equal(want, np.argmin(dist, axis=1))
    # against the plain version: distances within fp32 rounding, indices
    # equal wherever the plain top-2 gap is past that rounding
    zt, et = torch.from_numpy(z), torch.from_numpy(e)
    plain = (torch.sum(et * et, -1)[None] - 2.0 * (zt @ et.T)).numpy()
    np.testing.assert_allclose(dist, plain, atol=2e-6, rtol=0)
    ref = t_cb._nearest_codes_reference(zt, et).numpy()
    top2 = np.sort(plain, axis=1)[:, :2]
    differ = want != ref
    assert (top2[differ, 1] - top2[differ, 0] <= 1e-5).all()
