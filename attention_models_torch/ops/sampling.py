"""Sampling and masking ops of the token-space generators, and the fused
decode-step epilogue: kernel (csrc/sampling.cu) and plain version.

Counterpart of ``attention_models_tpu/ops/sampling.py``, same semantics:

- ``cosine_schedule``: cos(t * pi / 2).
- ``filter_logits``: keep the top ``ceil((1 - p) * C)`` classes by count;
  exact mode keeps the lowest index among values tied at the k-th, as
  ``lax.top_k`` does (a stable descending sort: ``torch.topk``'s tie order
  is unspecified); approx mode thresholds at ``kth_value_bisect``.
- ``gumbel_argmax`` / ``sample_topk_filtered``: argmax(logits + T * gumbel)
  over the kept classes, temperature annealed to greedy.
- ``lowest_score_mask``: the ``num_to_mask`` lowest scores of each row, ties
  toward earlier positions (stable sort).

Every sampler takes an optional ``noise`` tensor of Gumbel draws (tests hand
it JAX's); otherwise it draws from the ``torch.Generator`` it is given.

``sample_epilogue_fused`` is the decode-step epilogue in one launch (CFG
combine, bisection top-k threshold, Gumbel argmax, the chosen class's
softmax probability) at any class count C % 4 == 0; the kernel finds the
bisection's threshold from histograms over the bisection tree's midpoints
(csrc/sampling.cu), bit-equal to ``kth_value_bisect``. Its noise bits are Philox4x32-10 keyed by (row seed,
step) with (column / 4, position under the seed) as the counter -- the
kernel and ``philox_bits`` compute the same stream -- or an int32 tensor
(``noise_bits``).

Training: ``random_mask`` (per-sample cosine mask rate, the lowest of a
uniform draw) and ``cross_entropy_ignore_index`` (the mean over
non-ignored positions, torch ``F.cross_entropy`` semantics).
"""

from __future__ import annotations

import math

import torch

from attention_models_torch.ops import _build
from attention_models_torch.ops.dispatch import check_tensor, is_kernel_path

def cosine_schedule(t: torch.Tensor) -> torch.Tensor:
    return torch.cos(t * (math.pi / 2))


def num_kept(n_classes: int, p: float) -> int:
    """k = ceil((1 - p) * C), the classes the top-p filter keeps."""
    return math.ceil((1 - p) * n_classes)


def kth_value_bisect(logits: torch.Tensor, k: int,
                     iters: int = 16) -> torch.Tensor:
    """Per-row threshold by counting bisection between min and max: the
    largest t found with count(x >= t) >= k (fp32), so the kept set holds
    the true top k."""
    x = logits.float()
    hi = x.amax(dim=-1)
    lo = x.amin(dim=-1)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        up = (x >= mid[..., None]).sum(dim=-1) >= k
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
    return lo


def topk_stable(logits: torch.Tensor, k: int):
    """(values, indices) of the k largest, lowest index first among ties."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def filter_logits(logits: torch.Tensor, p: float = 0.9,
                  approx: bool = False) -> torch.Tensor:
    """Keep the top ceil((1-p)*C) classes, the rest -inf."""
    k = num_kept(logits.shape[-1], p)
    if approx:
        kth = kth_value_bisect(logits, k)[..., None]
        return torch.where(logits.float() >= kth, logits,
                           torch.full_like(logits, float("-inf")))
    vals, idx = topk_stable(logits, k)
    return torch.full_like(logits, float("-inf")).scatter(-1, idx, vals)


def gumbel(shape, generator: torch.Generator | None = None,
           device=None) -> torch.Tensor:
    """fp32 Gumbel(0, 1) draws, -log(-log(u)) with u in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))


def gumbel_argmax(logits: torch.Tensor, temperature: float = 1.0, *,
                  generator: torch.Generator | None = None,
                  noise: torch.Tensor | None = None) -> torch.Tensor:
    """argmax(logits + temperature * Gumbel noise) over the last axis."""
    if noise is None:
        noise = gumbel(logits.shape, generator, logits.device)
    noised = logits.float() + torch.tensor(temperature, dtype=torch.float32) * noise
    return noised.argmax(dim=-1).to(torch.int32)


def sample_topk_filtered(logits: torch.Tensor, p: float = 0.9,
                         temperature: float = 1.0, approx: bool = False, *,
                         generator: torch.Generator | None = None,
                         noise: torch.Tensor | None = None):
    """``gumbel_argmax(filter_logits(logits, p), temperature)`` without the
    filtered copy: (pred ids int32, chosen pre-softmax logit fp32). Exact
    mode draws noise (..., k) over the shortlist, approx mode (..., C)."""
    k = num_kept(logits.shape[-1], p)
    t = torch.tensor(temperature, dtype=torch.float32)
    if approx:
        kth = kth_value_bisect(logits, k)[..., None]
        x = logits.float()
        if noise is None:
            noise = gumbel(x.shape, generator, x.device)
        noised = torch.where(x >= kth, x + t * noise,
                             torch.full_like(x, float("-inf")))
        pred = noised.argmax(dim=-1)
        chosen = x.gather(-1, pred[..., None])[..., 0]
        return pred.to(torch.int32), chosen
    vals, idx = topk_stable(logits, k)
    if noise is None:
        noise = gumbel(vals.shape, generator, vals.device)
    choice = (vals.float() + t * noise).argmax(dim=-1, keepdim=True)
    pred = idx.gather(-1, choice)[..., 0]
    chosen = vals.gather(-1, choice)[..., 0].float()
    return pred.to(torch.int32), chosen


def lowest_score_mask(scores: torch.Tensor, num_to_mask: int) -> torch.Tensor:
    """True at the ``num_to_mask`` lowest scores of each row (b, n); ties
    toward earlier positions."""
    order = torch.sort(scores, dim=-1, stable=True).indices
    iota = torch.arange(scores.shape[-1], device=scores.device)
    ranks = torch.empty_like(order).scatter_(-1, order, iota.expand_as(order))
    return ranks < num_to_mask


def masked_count(mask_prob: torch.Tensor, seq_len: int) -> torch.Tensor:
    """max(round(seq_len * mask_prob), 1) in fp32, rounding half to even as
    ``jnp.round`` does (``torch.round`` does too)."""
    return torch.round(seq_len * mask_prob.clamp(min=0.0)).clamp(min=1.0)


def random_mask(batch: int, seq_len: int, *,
                generator: torch.Generator | None = None, draws=None,
                device=None) -> torch.Tensor:
    """Training mask (batch, seq_len), True = masked: per sample
    t ~ U[0, 1), ``masked_count(cos(t pi / 2))`` positions, the lowest of a
    uniform (batch, seq_len) draw (stable ties). ``draws`` = (t (b,),
    rand (b, n)) replaces the two draws from ``generator`` (tests hand it
    JAX's ``uniform(t_key)`` and ``uniform(perm_key)``)."""
    if draws is None:
        t = torch.rand(batch, generator=generator, device=device)
        rand = torch.rand(batch, seq_len, generator=generator, device=device)
    else:
        t, rand = (torch.as_tensor(a, dtype=torch.float32, device=device)
                   for a in draws)
        if t.shape != (batch,) or rand.shape != (batch, seq_len):
            raise ValueError(f"mask draws {tuple(t.shape)}, "
                             f"{tuple(rand.shape)} for ({batch}, {seq_len})")
    num = masked_count(cosine_schedule(t), seq_len)
    return lowest_score_mask(rand, num[:, None])


def cross_entropy_ignore_index(logits: torch.Tensor, targets: torch.Tensor,
                               ignore_index: int = -1) -> torch.Tensor:
    """Mean cross-entropy of ``logits`` (..., C) in fp32 over the positions
    whose target is not ``ignore_index``; targets broadcast to the logits'
    leading shape and the count with them; 0 / max(count, 1)."""
    lead = logits.shape[:-1]
    tgt = torch.broadcast_to(targets, lead)
    valid = tgt != ignore_index
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, torch.where(valid, tgt, 0).long()[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp(min=1)


def mask_fill_inputs_and_targets(indices: torch.Tensor, mask: torch.Tensor,
                                 mask_token_id: int, ignore_index: int = -1):
    """inputs: masked positions -> mask token; targets: unmasked positions
    -> ignore_index."""
    inputs = torch.where(mask, torch.full_like(indices, mask_token_id), indices)
    targets = torch.where(mask, indices, torch.full_like(indices, ignore_index))
    return inputs, targets


# -- Philox4x32-10 (Salmon et al., SC'11), on int64 tensors of uint32 words --

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _mulhilo(m: int, b: torch.Tensor):
    """(hi, lo) words of the 64-bit product m * b, in 16-bit halves so the
    int64 arithmetic never overflows."""
    p1 = m * (b & 0xFFFF)
    p2 = m * (b >> 16)
    s = ((p2 & 0xFFFF) << 16) + p1
    return (p2 >> 16) + (s >> 32), s & _U32


def philox4x32_10(ctr, key):
    """The four output words of Philox4x32-10 for counters ``ctr`` (four
    int64 tensors) and keys ``key`` (two), all holding uint32 values."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_bits(seeds: torch.Tensor, rows_per_seed: int, step: int,
                n_classes: int) -> torch.Tensor:
    """The kernel's noise bits, (rows, C) int32: row r uses key
    (seeds[r // rows_per_seed], step) and counter (c // 4, r % rows_per_seed,
    0, 0), column c the word c % 4."""
    dev = seeds.device
    rows = seeds.numel() * rows_per_seed
    key0 = (seeds.long() & _U32).repeat_interleave(rows_per_seed)[:, None]
    key1 = torch.full_like(key0, step & _U32)
    pos = (torch.arange(rows, device=dev) % rows_per_seed)[:, None]
    grp = torch.arange(-(-n_classes // 4), device=dev)[None, :]
    zero = torch.zeros((), dtype=torch.long, device=dev)
    words = philox4x32_10((grp, pos, zero, zero), (key0, key1))
    bits = torch.stack([w.expand(rows, -1) for w in words], dim=-1)
    bits = bits.reshape(rows, -1)[:, :n_classes]
    return (bits - ((bits >> 31) << 32)).to(torch.int32)  # uint32 -> int32


def gumbel_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """u = (bits >>> 8) * 2^-24 + 2^-25 and g = -log(-log(u)), in fp32."""
    ubits = (bits.long() & _U32) >> 8
    u = ubits.float() * (2.0 ** -24) + (2.0 ** -25)
    return -torch.log(-torch.log(u))


def _check_seeds(seeds, lead) -> None:
    if seeds is None or seeds.numel() != lead[0]:
        raise ValueError(f"seeds: one per leading row ({lead[0]}), got "
                         f"{None if seeds is None else tuple(seeds.shape)}")


def _sample_epilogue_reference(logits, null_logits=None, *,
                               guidance_scale=1.0, p=0.9, temperature=1.0,
                               seeds=None, step=0, noise_bits=None, iters=16):
    """Plain version of the kernel, on any device: the arguments and results
    of ``sample_epilogue_fused``, the same noise bits (``philox_bits``)."""
    lead, C = logits.shape[:-1], logits.shape[-1]
    rows = math.prod(lead)
    if noise_bits is not None:
        bits = noise_bits.reshape(rows, C)
    else:
        _check_seeds(seeds, lead)
        bits = philox_bits(seeds.to(logits.device), rows // lead[0], step, C)
    x = logits.reshape(rows, C).float()
    if null_logits is not None:
        nl = null_logits.reshape(rows, C).float()
        x = nl + torch.tensor(guidance_scale, dtype=torch.float32) * (x - nl)
    kth = kth_value_bisect(x, num_kept(C, p), iters)[:, None]
    t = torch.tensor(temperature, dtype=torch.float32)
    noised = torch.where(x >= kth, x + t * gumbel_of_bits(bits),
                         torch.full_like(x, float("-inf")))
    pred = noised.argmax(dim=-1)
    chosen = x.gather(-1, pred[:, None])[:, 0]
    rmax = x.amax(dim=-1)
    lse = rmax + torch.log(torch.exp(x - rmax[:, None]).sum(dim=-1))
    return (pred.to(torch.int32).reshape(lead),
            torch.exp(chosen - lse).reshape(lead))


def sample_epilogue_fused(
    logits: torch.Tensor,                     # (b, ..., C) cond (or plain) logits
    null_logits: torch.Tensor | None = None,  # like logits, for CFG
    *,
    guidance_scale: float = 1.0,
    p: float = 0.9,
    temperature: float = 1.0,
    seeds: torch.Tensor | None = None,        # (b,) int, one per leading row
    step: int = 0,
    noise_bits: torch.Tensor | None = None,   # like logits, int32
    iters: int = 16,
):
    """The decode-step epilogue: (pred ids int32, softmax prob of the
    chosen class fp32), both shaped like the logits' leading dims. The
    kernel for CUDA tensors, the plain version (same Philox bits) for CPU
    tensors. Without ``noise_bits`` the noise of leading row i depends only
    on ``seeds[i]``, ``step`` and the position within the row."""
    if not is_kernel_path(logits):
        return _sample_epilogue_reference(
            logits, null_logits, guidance_scale=guidance_scale, p=p,
            temperature=temperature, seeds=seeds, step=step,
            noise_bits=noise_bits, iters=iters)
    lead, C = logits.shape[:-1], logits.shape[-1]
    rows = math.prod(lead)
    dev = logits.device
    cond = logits.reshape(rows, C)
    null = null_logits.reshape(rows, C) if null_logits is not None else None
    check_tensor(cond, "logits", (torch.float32, torch.bfloat16))
    if C % 4:
        raise ValueError(f"sample epilogue kernel: C={C} must be a multiple "
                         f"of 4")
    if null is not None:
        check_tensor(null, "null_logits", (cond.dtype,), 2, dev)
        if null.shape != cond.shape:
            raise ValueError("null_logits must match logits")
    if noise_bits is not None:
        bits = noise_bits.reshape(rows, C)
        check_tensor(bits, "noise_bits", (torch.int32,), 2, dev)
        if bits.shape != cond.shape:
            raise ValueError("noise_bits must match logits")
        seed_t = None
    else:
        _check_seeds(seeds, lead)
        bits = None
        seed_t = seeds.to(device=dev, dtype=torch.int64).contiguous()
    if any(t.data_ptr() % 16 for t in (cond, null, bits) if t is not None):
        raise ValueError("sample epilogue kernel: operands must be 16-byte "
                         "aligned")
    pred = torch.empty(rows, dtype=torch.int32, device=dev)
    score = torch.empty(rows, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _build.launch(
            "amt_sample_epilogue", cond.data_ptr(),
            null.data_ptr() if null is not None else None,
            bits.data_ptr() if bits is not None else None,
            seed_t.data_ptr() if seed_t is not None else None,
            rows // lead[0], step, pred.data_ptr(), score.data_ptr(), rows, C,
            num_kept(C, p), iters, guidance_scale, temperature,
            _build.DTYPE_CODES[cond.dtype], _build.stream_of(cond),
        )
    sample_epilogue_fused.launches += 1
    return pred.reshape(lead), score.reshape(lead)


sample_epilogue_fused.launches = 0
