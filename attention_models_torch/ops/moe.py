"""Top-k expert dispatch, in PyTorch on either device.

Counterpart of ``attention_models_tpu/ops/moe.py`` (``topk_gate``,
``_combine_weights``, ``moe_linear_dense``, ``moe_linear_scatter``,
``resolve_moe_impl``, ``moe_linear``). The JAX package leaves this dispatch
to XLA (no Pallas kernel), so it has no kernel here either. Its
semantics, kept exactly:

- ``topk_gate``: the k largest gate logits, sorted descending, ties to the
  lower expert index (``lax.top_k``; a stable descending sort, since
  ``torch.topk`` promises no tie order on CUDA), with weights
  ``sigmoid(values)`` rounded to the logits' dtype.
- Products: a bf16 model's operands stay bf16-rounded and accumulate in
  fp32 (JAX's ``preferred_element_type=float32``). Here they are upcast to
  fp32 first, which is exact, so the product rounds once, in fp32. The
  expert bank is cast to the operand dtype first (``w.astype(op_t)``), and
  the fp32 bias is added to the fp32 product.
- ``moe_linear_scatter``: a bucket capacity of ``max(ceil(cf * n * k / E),
  1)`` (``n * k`` when ``capacity_factor`` is None). A (token, slot)
  pair's position in its expert's bucket is a running count over the
  flattened pairs, token-major (its rank in a stable sort by expert).
  Pairs at or past the capacity are dropped:
  they are written to a spare slot past the end of the bucket, never over
  the kept pair in the last slot, and read back as 0. Weights apply in
  fp32, the sum over the k slots is taken in fp32, then cast to x's dtype.

Every function is differentiable through autograd as XLA's autodiff
differentiates the JAX functions: gradients reach x, the bank, the bias and
the gate weights (not the selection).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from attention_models_torch.ops.sampling import topk_stable


def topk_gate(gate_logits: torch.Tensor, k: int):
    """(weights, selected) of the k largest logits: values sorted
    descending, ties to the lower index; weights sigmoid(values) in the
    logits' dtype."""
    vals, idx = topk_stable(gate_logits, k)
    return torch.sigmoid(vals).to(gate_logits.dtype), idx


def combine_weights(selected: torch.Tensor, weights: torch.Tensor | None,
                    num_experts: int) -> torch.Tensor:
    """The per-token combine vector over experts (..., E) in fp32 (JAX's
    ``_combine_weights``). Unweighted, a token that selects one expert
    twice counts it twice."""
    one_hot = F.one_hot(selected, num_experts).float()  # (..., k, E)
    if weights is None:
        return one_hot.sum(-2)
    return torch.einsum("...ke,...k->...e", one_hot, weights.float())


def _operands(x: torch.Tensor, w: torch.Tensor):
    """x and the bank as fp32 operands holding the values JAX multiplies:
    x in its dtype and the bank cast to it (fp32 for an fp32 model)."""
    return x.float(), w.to(x.dtype).float()


def moe_linear_dense(x: torch.Tensor, w: torch.Tensor,
                     selected: torch.Tensor,
                     weights: torch.Tensor | None = None,
                     b: torch.Tensor | None = None) -> torch.Tensor:
    """Every expert on every token, then the masked combine: x (..., d_in),
    bank (E, d_in, d_out), selected (..., k), weights (..., k), bias
    (E, d_out) -> (..., d_out) in x's dtype."""
    combine = combine_weights(selected, weights, w.shape[0])
    xf, wf = _operands(x, w)
    y = torch.einsum("...d,edh->...eh", xf, wf)
    if b is not None:
        y = y + b.float()
    return torch.einsum("...eh,...e->...h", y, combine).to(x.dtype)


def bucket_capacity(n: int, k: int, num_experts: int,
                    capacity_factor: float | None) -> int:
    """Slots per expert for n tokens routed to k experts each."""
    if capacity_factor is None:
        return n * k  # dropless
    return max(math.ceil(capacity_factor * n * k / num_experts), 1)


def expert_slots(selected: torch.Tensor, num_experts: int,
                 capacity_factor: float | None):
    """(pos, keep, capacity) of the flattened (token, slot) pairs of
    ``selected`` (..., k): each pair's position in its expert's bucket (a
    running count, token-major) and whether it is within the capacity."""
    k = selected.shape[-1]
    sel = selected.reshape(-1)
    n = sel.numel()
    cap = bucket_capacity(n // k, k, num_experts, capacity_factor)
    # a stable sort by expert keeps each expert's pairs in the flattened
    # order, so a pair's rank within its expert's run is the running count
    # (JAX's cumsum of the one-hot over the pairs; torch's scan along that
    # axis walks the pairs one at a time on the card)
    order = torch.sort(sel, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=sel.device))
    count = torch.bincount(sel, minlength=num_experts)
    pos = rank - (count.cumsum(0) - count)[sel]
    return pos, pos < cap, cap


def moe_linear_scatter(x: torch.Tensor, w: torch.Tensor,
                       selected: torch.Tensor,
                       weights: torch.Tensor | None = None,
                       b: torch.Tensor | None = None,
                       capacity_factor: float | None = None) -> torch.Tensor:
    """Capacity-bucketed dispatch: the kept pairs' rows gathered into
    (E, capacity, d_in) buckets, one product an expert, the results read
    back at each pair's slot (dropped pairs read 0) and summed over the k
    slots in fp32 -> (..., d_out) in x's dtype."""
    e, k, d_in = w.shape[0], selected.shape[-1], x.shape[-1]
    xf = x.reshape(-1, d_in)
    n = xf.shape[0]
    sel = selected.reshape(-1)
    pos, keep, cap = expert_slots(selected, e, capacity_factor)
    tok = torch.arange(n, device=x.device).repeat_interleave(k)
    # dropped pairs land in the spare slot `cap`, which is cut off
    slot = torch.where(keep, pos, cap)
    buckets = xf.new_zeros(e, cap + 1, d_in).index_put((sel, slot), xf[tok])
    bf, wf = _operands(buckets[:, :cap], w)
    y = torch.bmm(bf, wf)
    if b is not None:
        y = y + b.float()[:, None, :]
    out = y[sel, torch.where(keep, pos, 0)]  # (n * k, d_out)
    out = torch.where(keep[:, None], out, torch.zeros_like(out))
    if weights is not None:
        out = out * weights.reshape(-1, 1).float()
    out = out.reshape(n, k, -1).sum(1)
    return out.reshape(*x.shape[:-1], -1).to(x.dtype)


def resolve_moe_impl(impl: str, num_experts: int) -> str:
    """"auto" is the dense combine up to 8 experts and the scatter past
    them (the dense path holds an E-wide intermediate); "dense" and
    "scatter" stay; anything else raises."""
    if impl == "auto":
        return "dense" if num_experts <= 8 else "scatter"
    if impl not in ("dense", "scatter"):
        raise ValueError(f"unknown moe impl {impl!r}")
    return impl


def moe_linear(x: torch.Tensor, w: torch.Tensor, selected: torch.Tensor,
               weights: torch.Tensor | None = None,
               b: torch.Tensor | None = None, impl: str = "auto",
               capacity_factor: float | None = None) -> torch.Tensor:
    """The routed linear through ``resolve_moe_impl(impl, E)``'s path."""
    if resolve_moe_impl(impl, w.shape[0]) == "dense":
        return moe_linear_dense(x, w, selected, weights, b)
    return moe_linear_scatter(x, w, selected, weights, b,
                              capacity_factor=capacity_factor)
