"""Ring (context-parallel) flash attention over n shards of the sequence.

Counterpart of ``attention_models_tpu/ops/ring_attention.py``. Shard i keeps
its q chunk and, at ring step s, holds the k/v chunk of shard (i - s) mod n;
each step runs the per-head flash forward (kernel 16) on the pair and merges
it into the running o and lse with the online-softmax rule, in fp32, o
renormalised at every step. The backward recomputes each chunk's partials
from the GLOBAL lse and delta (kernels 17 and 18), so its gradients are
exact: dq sums at home while the dk and dv accumulators travel with their
chunks and are home after n shifts; all three are summed in fp32 and cast
once.

Causal: step 0 is the diagonal (the causal kernel); at step s > 0 shard i's
visiting chunk is wholly in its past (i >= s) or wholly in its future (a
chunk that wrapped past shard 0). A wrapped chunk's partials are computed
and discarded, as the TPU ring does: its lse becomes -1e30, and its
gradients are dropped with ``torch.where``, never a multiply, because
P = exp(S - lse) against the global lse can overflow to Inf there and
0 * Inf is NaN. A ring of n shards launches kernel 16 n^2 times forward and
kernels 17 and 18 n^2 times each backward.

Here the n shards are n entries of a list in one process on one card, and
``_shift`` (the JAX package's ``ppermute`` shift) rotates the lists; over a
process group it becomes a send to the next rank and a receive from the
previous one, and nothing else in the loop changes.
"""

from __future__ import annotations

import torch

from attention_models_torch.ops.dispatch import needs_grad
from attention_models_torch.ops.flash_attention import (
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_delta,
    flash_forward,
)

_NEG_INF = -1e30


def _shift(*shards: list) -> tuple[list, ...]:
    """Rotate each list of per-shard values one step around the ring: shard
    i's value moves to shard i + 1."""
    return tuple(xs[-1:] + xs[:-1] for xs in shards)


def _live(n: int, device) -> torch.Tensor:
    """live[my, s]: at step s shard ``my`` holds the chunk of shard my - s,
    live unless that index wrapped past 0 (a chunk in its future). Built on
    the device once, so the loop copies nothing from the host (a pageable
    host-to-device copy would wait for the card at every step)."""
    i = torch.arange(n, device=device)
    return i[:, None] >= i[None, :]


def _ring_forward(qs, ks, vs, *, causal: bool, scale: float):
    """Local shards (b, h, t/n, d) -> (o per shard, lse per shard fp32)."""
    n = len(qs)
    live = _live(n, qs[0].device)
    kc, vc = list(ks), list(vs)
    o, lse = [None] * n, [None] * n
    for s in range(n):
        for my in range(n):
            o_i, lse_i = flash_forward(qs[my], kc[my], vc[my], scale=scale,
                                       causal=causal and s == 0)
            if causal and s > 0:
                lse_i = torch.where(live[my, s], lse_i, _NEG_INF)
            if o[my] is None:
                o[my], lse[my] = o_i.float(), lse_i
                continue
            m = torch.maximum(lse[my], lse_i)
            w_old = torch.exp(lse[my] - m)[..., None]
            w_new = torch.exp(lse_i - m)[..., None]
            acc = o[my] * w_old + o_i.float() * w_new
            lse[my] = m + torch.log(w_old[..., 0] + w_new[..., 0])
            o[my] = acc / (w_old + w_new)  # keep o normalised each step
        if s != n - 1:
            kc, vc = _shift(kc, vc)
    return [oi.to(q.dtype) for oi, q in zip(o, qs)], lse


def _ring_backward(qs, ks, vs, os, lses, gs, *, causal: bool, scale: float):
    n = len(qs)
    live = _live(n, qs[0].device)
    delta = [flash_delta(o, g) for o, g in zip(os, gs)]
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
          for q in qs]
    kc, vc = list(ks), list(vs)
    dk_acc = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
              for k in ks]
    dv_acc = [torch.zeros(v.shape, dtype=torch.float32, device=v.device)
              for v in vs]
    for s in range(n):
        step_causal = causal and s == 0
        for my in range(n):
            dq_i = flash_bwd_dq(kc[my], vc[my], qs[my], gs[my], lses[my],
                                delta[my], scale=scale, causal=step_causal)
            dk_i, dv_i = flash_bwd_dkv(qs[my], gs[my], lses[my], delta[my],
                                       kc[my], vc[my], scale=scale,
                                       causal=step_causal)
            if causal and s > 0:
                # select, don't multiply: see the module's docstring
                dq_i = torch.where(live[my, s], dq_i, 0.0)
                dk_i = torch.where(live[my, s], dk_i, 0.0)
                dv_i = torch.where(live[my, s], dv_i, 0.0)
            dq[my] = dq[my] + dq_i.float()
            dk_acc[my] = dk_acc[my] + dk_i.float()
            dv_acc[my] = dv_acc[my] + dv_i.float()
        # the accumulators travel with their chunk and are home after n
        # shifts; on the last hop k and v are not read again
        if s != n - 1:
            kc, vc, dk_acc, dv_acc = _shift(kc, vc, dk_acc, dv_acc)
        else:
            dk_acc, dv_acc = _shift(dk_acc, dv_acc)
    return ([a.to(q.dtype) for a, q in zip(dq, qs)],
            [a.to(k.dtype) for a, k in zip(dk_acc, ks)],
            [a.to(v.dtype) for a, v in zip(dv_acc, vs)])


class _Ring(torch.autograd.Function):
    """The ring forward; its exact backward from the global lse."""

    @staticmethod
    def forward(ctx, n, causal, scale, *shards):
        qs, ks, vs = shards[:n], shards[n:2 * n], shards[2 * n:]
        os, lses = _ring_forward(qs, ks, vs, causal=causal, scale=scale)
        ctx.n, ctx.causal, ctx.scale = n, causal, scale
        ctx.save_for_backward(*qs, *ks, *vs, *os, *lses)
        return tuple(os)

    @staticmethod
    def backward(ctx, *gs):
        n = ctx.n
        saved = ctx.saved_tensors
        qs, ks, vs, os, lses = (saved[i * n:(i + 1) * n] for i in range(5))
        dq, dk, dv = _ring_backward(qs, ks, vs, os, lses,
                                    [g.contiguous() for g in gs],
                                    causal=ctx.causal, scale=ctx.scale)
        return (None, None, None, *dq, *dk, *dv)


def ring_attention_local(qs, ks, vs, *, causal: bool = False,
                         scale: float | None = None) -> list[torch.Tensor]:
    """The ring over n shards: ``qs``, ``ks`` and ``vs`` hold each shard's
    local (b, h, t/n, d) q, k and v, in ring order; returns each shard's
    output. Differentiable (the exact ring backward). The counterpart of the
    JAX package's ``ring_attention_local``, with the mesh axis of n devices
    as n entries of a list."""
    n = len(qs)
    if not n or len(ks) != n or len(vs) != n:
        raise ValueError(f"ring: {len(qs)} q, {len(ks)} k and {len(vs)} v "
                         f"shards")
    if scale is None:
        scale = qs[0].shape[-1] ** -0.5
    if needs_grad(*qs, *ks, *vs):
        return list(_Ring.apply(n, causal, scale, *qs, *ks, *vs))
    return _ring_forward(qs, ks, vs, causal=causal, scale=scale)[0]


def ring_flash_attention(q, k, v, n: int, *, causal: bool = False,
                         scale: float | None = None) -> torch.Tensor:
    """Ring attention over GLOBAL (b, h, t, d) tensors on n shards of the
    sequence (views, no copies): the JAX package's ``ring_flash_attention``
    with a ring of n. t must divide by n."""
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(f"ring: sequence lengths {q.shape[2]}, {k.shape[2]} "
                         f"do not divide by {n} shards")
    shards = [list(t.chunk(n, dim=2)) for t in (q, k, v)]
    return torch.cat(ring_attention_local(*shards, causal=causal,
                                          scale=scale), dim=2)
