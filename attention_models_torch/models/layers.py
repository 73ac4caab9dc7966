"""Layers of the ViTVQGAN, ViT and MaskGIT paths: LayerNorm, Mlp, the fused
pre-LN MLP block; the gamma-only LayerNorm, the GEGLU FeedForward,
Dropout, Parti's sinusoidal positional encoding, the learned
L2-normalised position table and the dtype-following Conv2d.

Counterparts of ``attention_models_tpu/models/layers.py``. Parameter names
are the reference PyTorch modules' (``weight``/``bias``; the Mlp is a
``Sequential`` of Linear, GELU, Linear, so its keys are ``0.*`` and ``2.*``;
the FeedForward's ``ff`` is Linear, GEGLU, GammaLayerNorm, Linear).

``Linear`` casts its weight and bias to the activations' dtype at use (an
autograd-tracked ``.to()``, a no-op when they already are in it), so a model
may hold fp32 parameters and compute in bf16, as flax's ``dtype=`` does.

Modules that call a kernel carry ``kernels`` (default True). With it, each
op dispatches on its tensor's device: kernel on CUDA, plain on the CPU.
``ViTVQGAN.use_kernels(False)`` switches a whole model to the plain versions,
which is how the kernels are compared with them on the card.

``quant`` (None, "int8" or "int8_wide") selects the W8A8 inference paths as
the JAX package's modules do: an "int8" ``Linear`` runs ``quant_dot``; the
``FeedForward`` runs kernel 19 under "int8" and kernel 20 under "int8_wide";
``ln_mlp_block`` runs kernel 21 under "int8". Their quantized weights come
from the module's ``q8`` cache (``ops/quant.py::QuantCache``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from attention_models_torch.ops.codebook import l2_normalize
from attention_models_torch.ops.ffn import (
    _ffn_reference,
    _fused_mlp_reference,
    _ln_mlp_reference,
    ffn_supported,
    fused_ffn,
    fused_ln_mlp,
    fused_mlp,
    gelu_exact,
    mlp_supported,
)
from attention_models_torch.ops.layernorm import _ln_reference, layernorm
from attention_models_torch.ops.quant import (
    QuantCache,
    _ffn_q8_reference,
    _ffn_q8wide_reference,
    _ln_mlp_q8_reference,
    check_mode,
    ffn_q8_tileable,
    fused_ffn_q8,
    fused_ffn_q8wide,
    fused_ln_mlp_q8,
    ln_mlp_q8_tileable,
    quant_dot,
)


class LayerNorm(nn.Module):
    """LayerNorm with learnable weight and bias, torch semantics, fp32
    statistics, output in the input's dtype."""

    eps = 1e-5

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.kernels = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = layernorm if self.kernels else _ln_reference
        return fn(x, self.weight, self.bias, self.eps)


class Linear(nn.Linear):
    """``nn.Linear`` computing in its input's dtype; with ``quant="int8"``
    the W8A8 ``quant_dot`` (output in the input's dtype), then the bias in
    that dtype, as the JAX package's int8 projections."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 quant: str | None = None):
        super().__init__(in_features, out_features, bias)
        self.quant = check_mode(quant)
        self.q8 = QuantCache()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias.to(x.dtype) if self.bias is not None else None
        if self.quant == "int8":
            y = quant_dot(x, self.q8.get("weight", self.weight))
            return y + bias if bias is not None else y
        return F.linear(x, self.weight.to(x.dtype), bias)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's dtype, as ``Linear``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias.to(x.dtype) if self.bias is not None else None
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def xformers_hidden(hidden_features: int) -> int:
    """ViTVQGAN FFN hidden width: (int(h*2/3)+7)//8*8."""
    return (int(hidden_features * 2 / 3) + 7) // 8 * 8


def mlp_fusable(x: torch.Tensor, dim: int, dropout: float,
                deterministic: bool) -> bool:
    """The JAX package's gate of the fused MLP and of the fused pre-LN block
    (``Mlp.fusable``, ``ln_mlp_block``'s ``fusable``) without its backend
    test: dropout inactive, bf16 activations (the port computes in its
    input's dtype), ``mlp_supported`` and a lane-aligned ``dim`` that is
    x's width."""
    return ((dropout == 0.0 or deterministic) and x.dtype == torch.bfloat16
            and mlp_supported(x.shape, x.shape[-1]) and dim % 128 == 0
            and x.shape[-1] == dim)


def _mlp_chain(mlp: "Mlp", x: torch.Tensor, p: float, deterministic: bool,
               generator: torch.Generator | None, keeps) -> torch.Tensor:
    """Linear -> exact gelu -> dropout -> Linear -> dropout in x's dtype
    (flax's Mlp composition); ``keeps`` gives the two keep masks (tests)."""
    k1, k2 = keeps if keeps is not None else (None, None)
    h = dropout(gelu_exact(mlp[0](x)), p, deterministic, generator, k1)
    return dropout(mlp[2](h), p, deterministic, generator, k2)


class Mlp(nn.Sequential):
    """Linear -> exact GELU -> Linear, biased (the repaired reference FFN),
    keys ``0.*`` and ``2.*``, with flax's dropout after the gelu and after
    the second Linear when the forward is not ``deterministic``. Under the
    JAX package's gate (``mlp_fusable``) one fused op: kernels 7 and 8 on the
    card (``kernels``, the caller's switch), given the fp32 or bf16
    parameters as they are."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__(Linear(dim, hidden_dim), nn.GELU(),
                         Linear(hidden_dim, dim))
        self.p = check_rate(dropout)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None, keeps=None,
                kernels: bool = True) -> torch.Tensor:
        w1, _, w2 = self
        if mlp_fusable(x, w2.out_features, self.p, deterministic):
            fn = fused_mlp if kernels else _fused_mlp_reference
            return fn(x, w1.weight, w1.bias, w2.weight, w2.bias)
        return _mlp_chain(self, x, self.p, deterministic, generator, keeps)


def ln_mlp_block(x: torch.Tensor, norm: LayerNorm, mlp: Mlp, *,
                 kernels: bool = True, quant: str | None = None,
                 q8: QuantCache | None = None, dropout: float = 0.0,
                 deterministic: bool = True,
                 generator: torch.Generator | None = None,
                 keeps=None) -> torch.Tensor:
    """``x + mlp(norm(x))`` with ``dropout`` in the MLP. Under
    ``quant="int8"`` (inference only: active dropout is refused) the W8A8
    block, kernel 21 under the JAX gate and its plain version otherwise, in
    either dtype, its weights from ``q8``. Else, under the JAX package's gate
    (``mlp_fusable``), the whole block is one fused op (the ln_mlp kernels
    on the card, given the fp32 or bf16 parameters as they are); otherwise
    the module composition: the LayerNorm, then the MLP chain with its
    dropout drawn from ``generator`` (or the given ``keeps``)."""
    if quant == "int8":
        if dropout != 0.0 and not deterministic:
            raise ValueError(
                f"quant='int8' is an inference-only path; it cannot apply "
                f"active dropout (got dropout={dropout} with "
                f"deterministic=False)")
        q8 = q8 or QuantCache()
        args = (x, norm.weight, norm.bias, q8.get("w1", mlp[0].weight),
                mlp[0].bias, q8.get("w2", mlp[2].weight), mlp[2].bias)
        if kernels and ln_mlp_q8_tileable(x.shape, norm.weight.shape[0]):
            return fused_ln_mlp_q8(*args, eps=norm.eps)
        return _ln_mlp_q8_reference(*args, norm.eps)
    if mlp_fusable(x, norm.weight.shape[0], dropout, deterministic):
        args = (x, norm.weight, norm.bias, mlp[0].weight, mlp[0].bias,
                mlp[2].weight, mlp[2].bias)
        if kernels:
            return fused_ln_mlp(*args, eps=norm.eps)
        return _ln_mlp_reference(*args, norm.eps)
    return x + _mlp_chain(mlp, norm(x), dropout, deterministic, generator,
                          keeps)


class GammaLayerNorm(nn.Module):
    """LayerNorm with a learnable ``gamma`` and a zero ``beta`` buffer that
    is never trained (the reference's gamma-only LayerNorm, whose
    ``state_dict`` holds both); it runs as the beta-less LayerNorm."""

    eps = 1e-5

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))
        self.register_buffer("beta", torch.zeros(dim))
        self.kernels = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = layernorm if self.kernels else _ln_reference
        return fn(x, self.gamma, None, self.eps)


class GEGLU(nn.Module):
    """a, gate = chunk(2): gate * gelu(a), gelu on the FIRST half."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = x.chunk(2, dim=-1)
        return gate * gelu_exact(a)


class FeedForward(nn.Module):
    """GEGLU FFN: Linear(2 * inner, no bias) -> GEGLU -> GammaLayerNorm(inner)
    -> Linear(dim, no bias), inner = int(dim * mult * 2 / 3); keys ``ff.0``,
    ``ff.2.gamma``, ``ff.3``. Under the JAX package's gate (``ffn_supported``)
    the whole block is one fused op (the ffn kernel on the card); otherwise
    the unfused chain, its LayerNorm through the LayerNorm op. ``quant``:
    "int8" runs the W8A8 block (kernel 19), "int8_wide" the wide-only one
    (kernel 20), each under the JAX gate and as its plain version
    otherwise."""

    def __init__(self, dim: int, mult: float = 4, quant: str | None = None):
        super().__init__()
        inner = int(dim * mult * 2 / 3)
        self.dim = dim
        self.ff = nn.Sequential(Linear(dim, 2 * inner, bias=False), GEGLU(),
                                GammaLayerNorm(inner),
                                Linear(inner, dim, bias=False))
        self.quant = check_mode(quant)
        self.q8 = QuantCache()
        self.kernels = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w1, _, norm, w2 = self.ff
        inner = norm.gamma.shape[0]
        if self.quant is not None:
            fused = self.kernels and ffn_q8_tileable(x.shape, self.dim, inner)
            q2 = self.q8.get("w2", w2.weight)
            if self.quant == "int8":
                fn = fused_ffn_q8 if fused else _ffn_q8_reference
                return fn(x, self.q8.get("w1", w1.weight), norm.gamma, q2,
                          eps=norm.eps)
            fn = fused_ffn_q8wide if fused else _ffn_q8wide_reference
            return fn(x, w1.weight, norm.gamma, q2, eps=norm.eps)
        if ffn_supported(x.shape, x.shape[-1], inner):
            fn = fused_ffn if self.kernels else _ffn_reference
            return fn(x, w1.weight, norm.gamma, w2.weight, eps=norm.eps)
        return self.ff(x)


def check_rate(p: float) -> float:
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {p}")
    return float(p)


def dropout(x: torch.Tensor, p: float, deterministic: bool = True,
            generator: torch.Generator | None = None,
            keep: torch.Tensor | None = None) -> torch.Tensor:
    """flax ``nn.Dropout(p)``: keep ~ bernoulli(1 - p), then
    ``where(keep, x / (1 - p), 0)`` in x's dtype. The draw comes from the
    ``torch.Generator`` the caller passes (on x's device; the trainer owns
    it) or is a given ``keep`` mask (tests). The identity when
    ``deterministic`` or p = 0. No kernel: plain tensor code, as in JAX."""
    if deterministic or p == 0.0:
        return x
    if keep is None:
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class Dropout(nn.Module):
    """``dropout`` at a fixed rate, as a module."""

    def __init__(self, p: float):
        super().__init__()
        self.p = check_rate(p)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None,
                keep: torch.Tensor | None = None) -> torch.Tensor:
        return dropout(x, self.p, deterministic, generator, keep)


def pe_table(dim: int, max_len: int = 5000) -> torch.Tensor:
    """The fixed (max_len, dim) fp32 sin / cos table of the JAX package's
    ``SinusoidalPositionalEncoding.pe_table``: sin(pos * div) in the even
    columns, cos in the odd, div = exp(arange(0, dim, 2) * -ln(10^4) / dim)."""
    position = torch.arange(max_len, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros(max_len, dim)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe


class SinusoidalPositionalEncoding(nn.Module):
    """x + pe[offset:offset + t] (cast to x's dtype), then dropout at
    ``dropout`` (default 0.1, the JAX module's). The table is computed once
    on the host in fp32 and held as a buffer outside the ``state_dict``, so
    every device adds the same values."""

    def __init__(self, dim: int, dropout: float = 0.1, max_len: int = 5000):
        super().__init__()
        self.drop = Dropout(dropout)
        self.register_buffer("pe", pe_table(dim, max_len), persistent=False)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None, offset: int = 0,
                keep: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.pe[offset:offset + x.shape[1]].to(x.dtype)
        return self.drop(x, deterministic, generator, keep)


class AbsolutePositionalEmbedding(nn.Module):
    """A learned (max_len, dim) position table, its rows L2-normalised at
    lookup (the JAX package's ``AbsolutePositionalEmbedding``, kept for API
    parity: no model uses it); key ``emb.weight``."""

    def __init__(self, dim: int, max_len: int):
        super().__init__()
        self.emb = nn.Embedding(max_len, dim)

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.emb(positions.long()))


def lecun_normal_(w: torch.Tensor, generator: torch.Generator,
                  fan_in: int | None = None) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal (+-2 sd) with variance
    1/fan_in, fan_in being the size of one output row of a torch Linear
    (in) or Conv2d (in * kh * kw) weight unless given (flax counts an
    (E, in, out) expert bank's fan_in as E * in)."""
    fan_in = w[0].numel() if fan_in is None else fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)
