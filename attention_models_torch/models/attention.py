"""The attention primitives: SoftmaxAttention (with its KV-cached decode
mode), SwitchHeadAttention and AgentAttention.

Counterparts of ``attention_models_tpu/models/attention.py``.

``SoftmaxAttention`` has the reference's parameter names: no-bias ``q.0``,
fused no-bias ``kv.0`` whose output is viewed as (b, t, 2, h, d), biased
``W_o``, scale ``d ** -0.5``. Self-attention, or cross-attention to a
``context`` whose kv keeps its own batch, with an optional ``context_mask``
(b, tk) keep mask. ``kv.0`` takes ``context_dim`` features (default
``dim``): flax's Dense infers its input width, and Parti's cross-attention
reads the unprojected CLIP output (768 wide) from a 1024-wide decoder.

Dispatch is the JAX package's ``_dispatch_attention`` on one device: without
a mask and where ``flash_supported`` holds, the flash op (SoftmaxAttention:
on the packed kv, which goes to it unsplit; on the card its backward
returns the packed (dk, dv) cotangent, so the split never happens in either
direction; SwitchHeadAttention: ``flash_attention_bthd`` on separate q, k
and v, kernels 9 and 10); otherwise the plain ``multihead_attention`` with
the masks, as JAX runs XLA there (Muse's cross-attention over 77 text
tokens, the shapes below 128 tokens). Causal attention is bottom-right
aligned on both paths, and tq > tk with ``causal`` raises. A flash-sized kv
batch unlike q's raises a ValueError: the JAX package's separate-k/v
kernel, the only one there that takes separate k and v, reads k and v at
q's batch index, so it defines no result for that shape.

Decode (``cache``, a ``KVCache``; JAX's ``_decode_attention``): the
self-attention of one new token writes its k and v into the layer's cache
at the shared index, then attends over all ``max_len`` slots: fp32 scores
of (q * scale) against every cached key, the slots past the index at
-1e9, the fp32 softmax cast to q's dtype, times the cached values
(``multihead_attention`` with that mask). The index advances after the
whole stack (``transformer.Decoder``). Cross-attention needs no cache: its
k and v come from the context at every step, as in JAX. Plain PyTorch on
both devices, as JAX runs XLA there.
``dropout`` drops q, the packed kv and the output, as the JAX module does,
when the forward is not ``deterministic``. ``quant="int8"`` runs the three
projections through ``quant_dot`` (JAX's ``_proj``); "int8_wide" leaves
them in the model dtype.

``SwitchHeadAttention``: dense per-head ``q.0`` and ``k.0`` (dropout on
each); V from a top-k routed expert bank ``experts_v`` (E, dim, d_head),
gated by ``W_s.0`` with weights sigmoid(top-k logits), always as the dense
fp32 product (the bank's outputs shared across heads, (b, t, E, d_head)),
combined per head and cast to the compute dtype; the attention; then the
output MoE, gated by ``W_d.0`` on the attention's input (not its output)
and UNWEIGHTED (the gate values are computed and not applied, the
reference's quirk, so ``W_d.0`` gets no gradient), a routed ``experts_out``
(E, d_head, dim) summed over heads in fp32: the scatter dispatch (rounded
to the compute dtype inside it, then upcast) for E > 8 under "auto", the
dense fp32 product otherwise. The reference holds the banks as one
``Linear`` an expert (``experts_v.{i}.weight``, ``experts_out.{i}.weight``);
here they are stacked, as in JAX, for one batched product.

``AgentAttention``: fused no-bias ``qkv``, biased ``W_o``; agent tokens pool
q, viewed as (b, d, t, h), over (t, h) to (sqrt(a), sqrt(a)) and are read
back as (heads, agents), so the module needs ``num_heads ==
int(agent_num ** 0.5)`` (a ValueError otherwise); two softmax stages whose
products accumulate in fp32 (scalar fp32 biases ``bias1`` and ``bias2``),
the probabilities rounded to the compute dtype; a depthwise 3 x 3
convolution of v over the (heads, time) grid with d channels (``dwc.1``,
as the reference's ``Sequential``) added; ``W_o`` and dropout.
``context_mask`` is accepted and unused, as in the reference. No JAX model
uses it, and it has no kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from attention_models_torch.models.layers import (
    Conv2d,
    Dropout,
    Linear,
    lecun_normal_,
)
from attention_models_torch.ops.attention import (
    make_causal_mask,
    multihead_attention,
)
from attention_models_torch.ops.flash_attention import (
    _check_causal_lengths,
    _flash_bthd_reference,
    _flash_reference,
    flash_attention_bthd,
    flash_attention_bthd_kv,
    flash_supported,
)
from attention_models_torch.ops.moe import (
    combine_weights,
    moe_linear_scatter,
    resolve_moe_impl,
    topk_gate,
)


def _check_kv_batch(kv_batch: int, b: int) -> None:
    if kv_batch != b:
        raise ValueError(
            f"flash attention over a kv batch ({kv_batch}) unlike q's ({b}) "
            f"has no defined result: the JAX package's separate-k/v kernel "
            f"(_flash_kernel_mh, grid over q's batch) reads k and v at q's "
            f"batch index")


def _heads(a: torch.Tensor) -> torch.Tensor:
    """(b, t, h, d) <-> (b, h, t, d)."""
    return a.transpose(1, 2)


def dispatch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       scale: float, causal: bool = False,
                       causal_mask: torch.Tensor | None = None,
                       context_mask: torch.Tensor | None = None,
                       kernels: bool = True) -> torch.Tensor:
    """JAX's ``_dispatch_attention`` on one device for separate q (b, tq, h,
    d) and k, v (b, tk, h, d): ``flash_attention_bthd`` (kernels 9 and 10 on
    the card; with ``kernels`` False its plain version) without masks at
    ``flash_supported`` shapes, else ``multihead_attention`` with the masks
    (``causal`` adds the bottom-right causal mask). Returns (b, tq, h, d)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if causal and tq > tk:
        _check_causal_lengths(tq, tk)
    if causal_mask is None and context_mask is None and flash_supported(
            (b, h, tq, d), (k.shape[0], h, tk, d), q.element_size()):
        _check_kv_batch(k.shape[0], b)
        if kernels:
            return flash_attention_bthd(q, k, v, scale=scale,
                                        causal=causal)[0]
        return _flash_bthd_reference(q, k, v, scale, causal)[0]
    if causal and causal_mask is None:
        causal_mask = make_causal_mask(tq, tk, device=q.device)
    return _heads(multihead_attention(
        _heads(q), _heads(k), _heads(v), scale=scale,
        causal_mask=causal_mask, context_mask=context_mask))


class KVCache:
    """The decode state of a ``Decoder``'s self-attention: per layer K and V
    (b, h, max_len, d) in the model's dtype, zeros at first, and the one
    write index all layers share (a host integer: no synchronisation)."""

    def __init__(self, depth: int, batch: int, heads: int, max_len: int,
                 d_head: int, dtype: torch.dtype, device: torch.device):
        shape = (batch, heads, max_len, d_head)
        self.keys = [torch.zeros(shape, dtype=dtype, device=device)
                     for _ in range(depth)]
        self.values = [torch.zeros(shape, dtype=dtype, device=device)
                       for _ in range(depth)]
        self.slots = torch.arange(max_len, device=device)
        self.max_len, self.index = max_len, 0


class SoftmaxAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0, quant: str | None = None,
                 context_dim: int | None = None):
        super().__init__()
        self.num_heads, self.dim_head = num_heads, dim_head
        proj_quant = "int8" if quant == "int8" else None
        inner = num_heads * dim_head
        self.q = nn.Sequential(Linear(dim, inner, bias=False, quant=proj_quant))
        self.kv = nn.Sequential(Linear(context_dim or dim, 2 * inner,
                                       bias=False, quant=proj_quant))
        self.W_o = Linear(inner, dim, quant=proj_quant)
        self.drop = Dropout(dropout)
        self.kernels = True

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None, *,
                context: torch.Tensor | None = None,
                context_mask: torch.Tensor | None = None,
                causal: bool = False, cache: KVCache | None = None,
                layer: int = 0) -> torch.Tensor:
        h, d = self.num_heads, self.dim_head
        b, t = x.shape[:2]
        src = x if context is None else context
        q = self.drop(self.q(x), deterministic, generator).view(b, t, h, d)
        kv = self.drop(self.kv(src), deterministic, generator).view(
            src.shape[0], src.shape[1], 2, h, d)
        scale = d ** -0.5
        if cache is not None and context is None:
            out = _heads(self._decode(_heads(q), kv, scale, cache, layer))
        elif context_mask is None and flash_supported(
                (b, h, t, d), (kv.shape[0], h, kv.shape[1], d),
                q.element_size()):
            _check_kv_batch(kv.shape[0], b)
            if self.kernels:
                out, _ = flash_attention_bthd_kv(q, kv, scale=scale,
                                                 causal=causal)
            else:
                out, _ = _flash_reference(q, kv, scale, causal)
        else:
            tk = kv.shape[1]
            if causal:
                _check_causal_lengths(t, tk)
            out = _heads(multihead_attention(
                _heads(q), _heads(kv[:, :, 0]), _heads(kv[:, :, 1]),
                scale=scale, context_mask=context_mask,
                causal_mask=make_causal_mask(t, tk, q.device) if causal
                else None))
        out = out.reshape(out.shape[0], out.shape[1], h * d)
        return self.drop(self.W_o(out), deterministic, generator)

    @staticmethod
    def _decode(qh: torch.Tensor, kv: torch.Tensor, scale: float,
                cache: KVCache, layer: int) -> torch.Tensor:
        """One new token's self-attention over the layer's cache, after
        writing its k and v at the cache's index; qh (b, h, 1, d)."""
        i = cache.index
        if qh.shape[2] != 1 or i >= cache.max_len:
            raise ValueError(
                f"cached decode takes one token a step within max_len "
                f"{cache.max_len} (got {qh.shape[2]} tokens at index {i})")
        keys, values = cache.keys[layer], cache.values[layer]
        keys[:, :, i] = kv[:, 0, 0]
        values[:, :, i] = kv[:, 0, 1]
        return multihead_attention(qh, keys, values, scale=scale,
                                   causal_mask=(cache.slots > i)[None])


class SwitchHeadAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8, dim_head: int = 64,
                 num_experts: int = 5, sel_experts: int = 2,
                 dropout: float = 0.0, moe_impl: str = "auto",
                 capacity_factor: float | None = None):
        super().__init__()
        h, d, e = num_heads, dim_head, num_experts
        self.num_heads, self.dim_head, self.num_experts = h, d, e
        self.sel_experts = sel_experts
        self.impl = resolve_moe_impl(moe_impl, e)  # the output MoE's
        self.capacity_factor = capacity_factor
        self.q = nn.Sequential(Linear(dim, h * d, bias=False))
        self.k = nn.Sequential(Linear(dim, h * d, bias=False))
        self.W_s = nn.Sequential(Linear(dim, h * e, bias=False))
        self.W_d = nn.Sequential(Linear(dim, h * e, bias=False))
        self.experts_v = nn.Parameter(torch.empty(e, dim, d))
        self.experts_out = nn.Parameter(torch.empty(e, d, dim))
        self.drop = Dropout(dropout)
        self.kernels = True
        self.reset_experts()

    def reset_experts(self, generator: torch.Generator | None = None) -> None:
        """flax's lecun-normal init of both banks (fan_in E * d_in)."""
        for w in (self.experts_v, self.experts_out):
            lecun_normal_(w, generator, fan_in=w.shape[0] * w.shape[1])

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None, *,
                context: torch.Tensor | None = None,
                causal_mask: torch.Tensor | None = None,
                context_mask: torch.Tensor | None = None,
                causal: bool = False) -> torch.Tensor:
        h, d, e = self.num_heads, self.dim_head, self.num_experts
        b, t = x.shape[:2]
        src = x if context is None else context
        q = self.drop(self.q(x), deterministic, generator).view(b, t, h, d)
        k = self.drop(self.k(src), deterministic, generator).view(
            *src.shape[:2], h, d)
        # V: the bank on every source token in fp32, combined per head
        wts_v, sel_v = topk_gate(self.W_s(src).unflatten(-1, (h, e)),
                                 self.sel_experts)
        vx = torch.einsum("btd,edh->bteh", src.float(), self.experts_v)
        v = torch.einsum("bteh,btxe->btxh", vx,
                         combine_weights(sel_v, wts_v, e)).to(x.dtype)
        out = dispatch_attention(q, k, v, scale=d ** -0.5, causal=causal,
                                 causal_mask=causal_mask,
                                 context_mask=context_mask,
                                 kernels=self.kernels)
        # the output MoE, unweighted, gated on the source tokens
        _, sel_o = topk_gate(self.W_d(src).unflatten(-1, (h, e)),
                             self.sel_experts)
        if self.impl == "scatter":
            y = moe_linear_scatter(out, self.experts_out, sel_o, None,
                                   capacity_factor=self.capacity_factor
                                   ).float()
        else:
            ox = torch.einsum("bthd,edD->btheD", out.float(),
                              self.experts_out)
            y = torch.einsum("btheD,bthe->bthD", ox,
                             combine_weights(sel_o, None, e))
        return y.sum(-2).to(x.dtype)


class _Permute(nn.Module):
    def __init__(self, *dims: int):
        super().__init__()
        self.dims = dims

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(*self.dims)


class AgentAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8, dim_head: int = 64,
                 agent_num: int = 47, dropout: float = 0.0):
        super().__init__()
        pool = int(agent_num ** 0.5)
        if num_heads != pool:
            raise ValueError(
                f"AgentAttention needs num_heads == int(agent_num ** 0.5): "
                f"the agents pool q over (time, heads) to ({pool}, {pool}) "
                f"and are read back as (heads, agents), so num_heads="
                f"{num_heads} does not fit agent_num={agent_num}")
        h, d = num_heads, dim_head
        self.num_heads, self.dim_head, self.pool = h, d, pool
        self.qkv = Linear(dim, 3 * h * d, bias=False)
        self.W_o = Linear(h * d, dim)
        self.bias1 = nn.Parameter(torch.zeros(1, 1, 1, 1))
        self.bias2 = nn.Parameter(torch.zeros(1, 1, 1, 1))
        # v (b, h, t, d) as an image of d channels over the (h, t) grid
        self.dwc = nn.Sequential(
            _Permute(0, 3, 1, 2), Conv2d(d, d, 3, padding=1, groups=d),
            _Permute(0, 2, 3, 1))
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None, *,
                context_mask: torch.Tensor | None = None) -> torch.Tensor:
        h, d = self.num_heads, self.dim_head
        b, t = x.shape[:2]
        scale = d ** -0.5
        q, k, v = self.qkv(x).view(b, t, 3, h, d).permute(2, 0, 3, 1, 4)
        # (b, d, t, h) pooled over (t, h), then read as (b, h, agents, d)
        agents = F.adaptive_avg_pool2d(q.permute(0, 3, 2, 1),
                                       self.pool).permute(0, 3, 2, 1)
        s1 = torch.einsum("bhid,bhjd->bhij", (agents * scale).float(),
                          k.float()) + self.bias1
        v_agent = torch.einsum("bhij,bhjd->bhid",
                               torch.softmax(s1, -1).to(x.dtype), v)
        s2 = torch.einsum("bhid,bhjd->bhij", (q * scale).float(),
                          agents.float()) + self.bias2
        out = torch.einsum("bhij,bhjd->bhid",
                           torch.softmax(s2, -1).to(x.dtype), v_agent)
        out = (out + self.dwc(v)).transpose(1, 2).reshape(b, t, h * d)
        return self.drop(self.W_o(out), deterministic, generator)
