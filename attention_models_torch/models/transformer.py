"""Pre-LN transformer stacks, loop form.

Counterpart of ``attention_models_tpu/models/transformer.py``'s
``EncoderLayer`` / ``Encoder``, ``DecoderLayer`` / ``Decoder`` and the
seq2seq ``Transformer`` (below). Keys are
the reference's (``attention_models_tpu/utils/torch_convert.py::
convert_encoder_layer`` / ``convert_decoder_layer``):
``layers.{i}.norm1.gamma``, ``layers.{i}.self_attn.{q.0,kv.0,W_o}``,
``layers.{i}.norm2.gamma``, ``layers.{i}.feed_forward.ff.{0,2.gamma,3}``;
a decoder layer adds ``cross_attn.*`` after ``norm2`` and ``norm3`` before
the FFN. The encoder's self-attention is bidirectional (MaskGIT's). The
decoder's is bidirectional (Muse) or ``causal``, bottom-right aligned
(Parti's teacher-forced forward); its cross-attention takes the ``context``
(``context_dim`` wide, default ``dim``) and its ``context_mask``. With a
``cache`` (``attention.KVCache``) the decoder runs one cached decode step
of one token a row: each layer's self-attention writes and reads its
cache, and the cache's index advances once after the stack.
``dropout`` is the attention's (on q, kv and its output) when the forward
is not ``deterministic``; the FFN has none, as in JAX. ``quant`` is the
W8A8 inference mode of every layer (``models/layers.py``).
``scan_layers``, ``remat`` and pipeline parallelism are not ported yet:
``models/factory.py::build_model`` refuses them.
"""

from __future__ import annotations

import torch
from torch import nn

import torch.nn.functional as F

from attention_models_torch.models.attention import KVCache, SoftmaxAttention
from attention_models_torch.models.layers import (
    FeedForward,
    GammaLayerNorm,
    Linear,
    SinusoidalPositionalEncoding,
    lecun_normal_,
)
from attention_models_torch.models.vitvqgan import ViTVQGAN
from attention_models_torch.ops.sampling import gumbel, gumbel_argmax


class EncoderLayer(nn.Module):
    """x + attn(norm1(x)), then x + feed_forward(norm2(x))."""

    def __init__(self, dim: int, n_heads: int = 8, d_head: int = 64,
                 mult: float = 4, dropout: float = 0.0,
                 quant: str | None = None):
        super().__init__()
        self.norm1 = GammaLayerNorm(dim)
        self.self_attn = SoftmaxAttention(dim, n_heads, d_head, dropout, quant)
        self.norm2 = GammaLayerNorm(dim)
        self.feed_forward = FeedForward(dim, mult, quant)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = x + self.self_attn(self.norm1(x), deterministic, generator)
        return x + self.feed_forward(self.norm2(x))


class Encoder(nn.Module):
    def __init__(self, dim: int, n_heads: int = 8, d_head: int = 64,
                 depth: int = 6, mult: float = 4, dropout: float = 0.0,
                 quant: str | None = None):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(dim, n_heads, d_head, mult, dropout, quant)
            for _ in range(depth))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, deterministic, generator)
        return x


class DecoderLayer(nn.Module):
    """x + self_attn(norm1(x)), x + cross_attn(norm2(x), context), then
    x + feed_forward(norm3(x))."""

    def __init__(self, dim: int, n_heads: int = 8, d_head: int = 64,
                 mult: float = 4, dropout: float = 0.0,
                 quant: str | None = None, context_dim: int | None = None):
        super().__init__()
        self.norm1 = GammaLayerNorm(dim)
        self.self_attn = SoftmaxAttention(dim, n_heads, d_head, dropout, quant)
        self.norm2 = GammaLayerNorm(dim)
        self.cross_attn = SoftmaxAttention(dim, n_heads, d_head, dropout,
                                           quant, context_dim)
        self.norm3 = GammaLayerNorm(dim)
        self.feed_forward = FeedForward(dim, mult, quant)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                context_mask: torch.Tensor | None = None,
                deterministic: bool = True,
                generator: torch.Generator | None = None, *,
                causal: bool = False, cache: KVCache | None = None,
                layer: int = 0) -> torch.Tensor:
        x = x + self.self_attn(self.norm1(x), deterministic, generator,
                               causal=causal, cache=cache, layer=layer)
        x = x + self.cross_attn(self.norm2(x), deterministic, generator,
                                context=context, context_mask=context_mask)
        return x + self.feed_forward(self.norm3(x))


class Decoder(nn.Module):
    """Self-attention (bidirectional, causal or cached) -> cross-attention
    -> FFN stack."""

    def __init__(self, dim: int, n_heads: int = 8, d_head: int = 64,
                 depth: int = 6, mult: float = 4, dropout: float = 0.0,
                 quant: str | None = None, context_dim: int | None = None):
        super().__init__()
        self.n_heads, self.d_head = n_heads, d_head
        self.layers = nn.ModuleList(
            DecoderLayer(dim, n_heads, d_head, mult, dropout, quant,
                         context_dim)
            for _ in range(depth))

    def new_cache(self, batch: int, max_len: int, dtype: torch.dtype,
                  device: torch.device) -> KVCache:
        """A zeroed cache of ``max_len`` slots for a decode of ``batch``
        rows."""
        return KVCache(len(self.layers), batch, self.n_heads, max_len,
                       self.d_head, dtype, device)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                context_mask: torch.Tensor | None = None,
                deterministic: bool = True,
                generator: torch.Generator | None = None, *,
                causal: bool = False,
                cache: KVCache | None = None) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x, context, context_mask, deterministic, generator,
                      causal=causal, cache=cache, layer=i)
        if cache is not None:
            cache.index += 1
        return x


class Transformer(nn.Module):
    """The seq2seq encoder-decoder LM (JAX's ``Transformer``): embeddings
    ``enc_input_proj`` / ``dec_input_proj``, the sinusoidal encoding with
    its dropout 0.1 (the model's only dropout), gamma LayerNorms around a
    bidirectional ``Encoder`` and a causal ``Decoder`` (the FFN's inner
    width int(dim * 8 / 3)), a biased ``linear`` head over ``n_classes``
    (default the vocabulary). Keys are those of ``torch_convert.py::
    convert_transformer``. ``dtype`` is the compute dtype over fp32
    parameters (None: the parameters' dtype); the embedding rows and the
    table are cast to it at use."""

    def __init__(self, dim: int, vocab_size: int = 1000, n_heads: int = 8,
                 d_head: int = 64, enc_depth: int = 6, dec_depth: int = 6,
                 n_classes: int | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = dtype
        self.enc_input_proj = nn.Embedding(vocab_size, dim)
        self.dec_input_proj = nn.Embedding(vocab_size, dim)
        self.pos_enc = SinusoidalPositionalEncoding(dim, dropout=0.1)
        self.enc_init_norm = GammaLayerNorm(dim)
        self.encoder = Encoder(dim, n_heads, d_head, enc_depth)
        self.enc_final_norm = GammaLayerNorm(dim)
        self.dec_init_norm = GammaLayerNorm(dim)
        self.decoder = Decoder(dim, n_heads, d_head, dec_depth)
        self.dec_final_norm = GammaLayerNorm(dim)
        self.linear = Linear(dim, n_classes or vocab_size)

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.linear.weight.dtype

    def reset_parameters(self, generator: torch.Generator) -> "Transformer":
        """The JAX package's inits: flax ``Embed``'s normal(1 / sqrt(dim))
        tables, lecun-normal Linear weights, zero biases, unit gammas."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    lecun_normal_(m.weight, generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, GammaLayerNorm):
                    m.gamma.fill_(1.0)
                elif isinstance(m, nn.Embedding):
                    m.weight.normal_(0.0, m.weight.shape[1] ** -0.5,
                                     generator=generator)
        return self

    use_kernels = ViTVQGAN.use_kernels

    def _embed(self, table: nn.Embedding, ids: torch.Tensor,
               deterministic: bool = True,
               generator: torch.Generator | None = None,
               offset: int = 0) -> torch.Tensor:
        x = F.embedding(ids.long(), table.weight).to(self.dtype)
        return self.pos_enc(x, deterministic, generator, offset)

    def encode(self, src_seq: torch.Tensor, deterministic: bool = True,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """Source ids (b, ts) -> the normed context (b, ts, dim)."""
        x = self.enc_init_norm(self._embed(self.enc_input_proj, src_seq,
                                           deterministic, generator))
        return self.enc_final_norm(self.encoder(x, deterministic, generator))

    def forward(self, src_seq: torch.Tensor, tgt_seq: torch.Tensor,
                deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Teacher-forced logits (b, tt, n_classes) in the compute dtype;
        the dropout draws from ``generator`` (the encoder's, then the
        decoder's) unless ``deterministic``."""
        context = self.encode(src_seq, deterministic, generator)
        x = self.dec_init_norm(self._embed(self.dec_input_proj, tgt_seq,
                                           deterministic, generator))
        x = self.decoder(x, context, deterministic=deterministic,
                         generator=generator, causal=True)
        return self.linear(self.dec_final_norm(x))

    def decode_step(self, tokens: torch.Tensor, pos: int,
                    context: torch.Tensor, cache: KVCache) -> torch.Tensor:
        """One cached step of ``generate``: the tokens (b, 1) at position
        ``pos`` -> the logits (b, n_classes) of position ``pos``, equal to
        row ``pos`` of the causal forward over the buffer without the
        decoder's init and final norms (JAX's ``generate`` applies neither)."""
        x = self._embed(self.dec_input_proj, tokens, offset=pos)
        return self.linear(self.decoder(x, context, cache=cache))[:, 0]

    @torch.no_grad()
    def generate(self, src_seq: torch.Tensor, max_len: int = 128,
                 start_token: int = 1, end_token: int = 2, *,
                 generator: torch.Generator | None = None,
                 noise: torch.Tensor | None = None) -> torch.Tensor:
        """Sampled ids (b, max_len + 1): ``start_token`` at column 0, then
        one token a step, argmax(logits + Gumbel noise) in fp32; a row that
        has sampled ``end_token`` is padded with it. The noise comes from
        ``generator`` (on the model's device) or is given as ``noise``
        (max_len, b, n_classes). Each step runs through the decoder's KV
        cache."""
        dev = self.linear.weight.device
        src_seq = torch.as_tensor(src_seq, device=dev)
        b = src_seq.shape[0]
        context = self.encode(src_seq)
        tokens = torch.full((b, max_len + 1), end_token, dtype=torch.long,
                            device=dev)
        tokens[:, 0] = start_token
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        cache = self.decoder.new_cache(b, max_len, self.dtype, dev)
        for t in range(max_len):
            last = self.decode_step(tokens[:, t:t + 1], t, context, cache)
            nz = (noise[t] if noise is not None
                  else gumbel(last.shape, generator, dev))
            nxt = gumbel_argmax(last, 1.0, noise=torch.as_tensor(
                nz, device=dev)).long()
            tokens[:, t + 1] = torch.where(done, end_token, nxt)
            done = done | (nxt == end_token)
        return tokens
