"""MaskGIT: a bidirectional transformer over the frozen ViTVQGAN's token
grid, and its iterative parallel decode.

Counterpart of ``attention_models_tpu/models/maskgit.py``. Keys: ``vq.*``
(the tokenizer, frozen), ``bidirectional_transformer.{input_proj.weight
(vocab + 1 rows, the last the mask token), pos_enc, init_norm,
decoder.layers.{i}, final_norm, linear.weight (no bias)}``. The embedding
table, ``pos_enc`` and the head are cast to the compute dtype at use, as
flax's ``dtype=`` does; the parameters stay in their own dtype.

``generate`` keeps the JAX loop step for step: ``ts = linspace(0, 1, T)``;
``num_to_mask = max(int(cos(t * pi / 2) * num_masked), 1)`` in fp32; the
lowest-confidence ``num_to_mask`` positions (stable, ties toward earlier
positions) within the re-maskable set are masked; the logits are sampled
with top-k filtered Gumbel noise at temperature ``steps_left / T``; the
scores are the chosen classes' softmax probabilities on the masked
positions and 1.0 elsewhere; the final ids are decoded by the tokenizer.
``quant`` is the W8A8 inference mode of the transformer (its layers, and
the head under "int8"), each weight quantized once per generate.
Exact mode draws its noise from one ``torch.Generator`` per row, approx
mode runs the fused epilogue (kernel on the card) with a Philox seed per
row, so a row's ids never depend on the rest of the batch. ``noise``
replaces both with given per-step Gumbel draws (approx mode then runs the
unfused chain, as the JAX package does off the TPU). ``generate`` runs
the deterministic forward (no dropout).

Training (``forward``, ``loss_from_indices``) keeps the JAX step: the
frozen tokenizer's indices, ``random_mask`` (drawn from the caller's
generator, or given draws), mask-token inputs and ignore-index targets,
then the transformer with ``targets``: its dropout active unless
``deterministic``, and the mean NLL over the masked positions through
``fused_head_xent`` under the JAX gate (``cross_entropy_ignore_index``
over the logits otherwise). One generator draws the mask, then the
dropout, in that order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from attention_models_torch.models.layers import (
    GammaLayerNorm,
    Linear,
    lecun_normal_,
)
from attention_models_torch.models.vitvqgan import ViTVQGAN
from attention_models_torch.models.transformer import Encoder
from attention_models_torch.models.vq_common import build_vq, vq_num_patches
from attention_models_torch.ops.quant import check_mode, weights_quantized_once
from attention_models_torch.ops.sampling import (
    _sample_epilogue_reference,
    cosine_schedule,
    cross_entropy_ignore_index,
    gumbel,
    lowest_score_mask,
    mask_fill_inputs_and_targets,
    num_kept,
    random_mask,
    sample_epilogue_fused,
    sample_topk_filtered,
)
from attention_models_torch.ops.xent import (
    _head_xent_loss_reference,
    fused_head_xent,
    head_xent_supported,
)


def decode_schedule(timesteps: int, num_masked: int) -> list[tuple[int, float]]:
    """(num_to_mask, temperature) of each decode step, in fp32 as the JAX
    loop computes them: ts = linspace(0, 1, T) (iota / (T - 1)),
    max(int(cos(t * pi / 2) * num_masked), 1), steps_left / T."""
    ts = torch.arange(timesteps, dtype=torch.float32)
    if timesteps > 1:
        ts = ts / (timesteps - 1)
    counts = (cosine_schedule(ts) * num_masked).to(torch.int32).clamp(min=1)
    return [(int(c), float(np.float32(timesteps - 1 - i) / np.float32(timesteps)))
            for i, c in enumerate(counts)]


def row_seeds(seeds, batch: int) -> torch.Tensor:
    """One int64 seed per row of a decode (default 0, 1, ...)."""
    seeds = torch.as_tensor(np.arange(batch) if seeds is None else
                            np.asarray(seeds), dtype=torch.int64)
    if seeds.shape != (batch,):
        raise ValueError(f"seeds: one per row ({batch}), got "
                         f"{tuple(seeds.shape)}")
    return seeds


class BiDirectionalTransformer(nn.Module):
    """Embedding(vocab + 1) + pos_enc -> gamma-LN -> Encoder -> gamma-LN ->
    no-bias head (W8A8 under ``quant="int8"``). ``dtype`` is the compute
    dtype (None: the parameters')."""

    def __init__(self, dim: int, vocab_size: int = 8192, num_patches: int = 256,
                 n_heads: int = 8, d_head: int = 64, dec_depth: int = 6,
                 mult: float = 4, dropout: float = 0.0,
                 dtype: torch.dtype | None = None, quant: str | None = None):
        super().__init__()
        self.compute_dtype = dtype
        self.quant = check_mode(quant)
        self.input_proj = nn.Embedding(vocab_size + 1, dim)
        self.pos_enc = nn.Parameter(torch.zeros(1, num_patches, dim))
        self.init_norm = GammaLayerNorm(dim)
        self.decoder = Encoder(dim, n_heads, d_head, dec_depth, mult, dropout,
                               quant)
        self.final_norm = GammaLayerNorm(dim)
        self.linear = Linear(dim, vocab_size, bias=False,
                             quant="int8" if quant == "int8" else None)
        self.kernels = True  # the fused head loss

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.linear.weight.dtype

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                targets: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Token ids (b, n) -> logits (b, n, vocab) in the compute dtype;
        with ``targets`` (b, n) the mean NLL over the non-ignored (-1)
        positions instead."""
        dt = self.dtype
        h = F.embedding(x.long(), self.input_proj.weight).to(dt)
        h = self.init_norm(h + self.pos_enc.to(dt))
        h = self.final_norm(self.decoder(h, deterministic, generator))
        if targets is None:
            return self.linear(h)
        vocab = self.linear.weight.shape[0]
        if self.quant is None and head_xent_supported(h.shape, h.shape[-1],
                                                      vocab):
            fn = (fused_head_xent if self.kernels
                  else _head_xent_loss_reference)
            return fn(h, self.linear.weight, targets)
        return cross_entropy_ignore_index(self.linear(h), targets)


class MaskGitTransformer(nn.Module):
    def __init__(self, dim: int, vq_config: dict, vocab_size: int = 8192,
                 n_heads: int = 8, d_head: int = 64, dec_depth: int = 6,
                 mult: float = 4, dropout: float = 0.0,
                 dtype: torch.dtype | None = None, quant: str | None = None):
        super().__init__()
        self.vq = build_vq(vq_config, dtype=dtype).requires_grad_(False)
        self.mask_token_id = vocab_size
        self.num_patches = vq_num_patches(vq_config)
        self.bidirectional_transformer = BiDirectionalTransformer(
            dim, vocab_size, self.num_patches, n_heads, d_head, dec_depth,
            mult, dropout, dtype, quant)
        self.kernels = True

    def forward(self, imgs: torch.Tensor, *, deterministic: bool = False,
                generator: torch.Generator | None = None,
                mask_draws=None) -> torch.Tensor:
        """The training loss of images (b, 3, H, W): the frozen tokenizer's
        indices, then ``loss_from_indices``."""
        return self.loss_from_indices(
            self.encode_to_indices(imgs), deterministic=deterministic,
            generator=generator, mask_draws=mask_draws)

    def loss_from_indices(self, indices: torch.Tensor, *,
                          deterministic: bool = False,
                          generator: torch.Generator | None = None,
                          mask_draws=None) -> torch.Tensor:
        """The training loss from token grids (b, n): ``random_mask`` from
        ``generator`` (or the given ``mask_draws`` = (t (b,), rand (b, n))),
        mask-token inputs, ignore-index targets, the transformer's mean NLL
        (its dropout from ``generator`` unless ``deterministic``)."""
        _, inputs, targets = self._masked(indices, generator, mask_draws)
        return self.bidirectional_transformer(
            inputs, deterministic=deterministic, targets=targets,
            generator=generator)

    def _masked(self, indices, generator, mask_draws):
        """(mask, inputs, targets) of token grids (b, n) under the training
        mask."""
        b, n = indices.shape
        mask = random_mask(b, n, generator=generator, draws=mask_draws,
                           device=indices.device)
        return (mask, *mask_fill_inputs_and_targets(indices.long(), mask,
                                                    self.mask_token_id))

    @torch.no_grad()
    def reconstruct(self, imgs: torch.Tensor, *,
                    generator: torch.Generator | None = None,
                    mask_draws=None) -> torch.Tensor:
        """The eval reconstruction: mask the images' tokens as in training,
        fill the masked ones with the deterministic forward's argmax, and
        decode."""
        indices = self.encode_to_indices(imgs).long()
        mask, inputs, _ = self._masked(indices, generator, mask_draws)
        pred = self.bidirectional_transformer(inputs).argmax(-1)
        return self.vq.decode_indices(torch.where(mask, pred, indices))

    use_kernels = ViTVQGAN.use_kernels  # the tokenizer's modules included

    def reset_parameters(self, generator: torch.Generator) -> "MaskGitTransformer":
        """The JAX package's inits: the tokenizer's own, lecun-normal Linear
        weights and zero biases, unit gammas, google-maskgit's normal(0.02)
        truncated at 2 sd for the embedding, position table and head."""
        self.vq.reset_parameters(generator)
        t = self.bidirectional_transformer
        with torch.no_grad():
            for m in t.modules():
                if isinstance(m, nn.Linear) and m is not t.linear:
                    lecun_normal_(m.weight, generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, GammaLayerNorm):
                    m.gamma.fill_(1.0)
            for p in (t.input_proj.weight, t.pos_enc, t.linear.weight):
                nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04,
                                      generator=generator)
        return self

    def encode_to_indices(self, imgs: torch.Tensor) -> torch.Tensor:
        """The frozen tokenizer's token grid (b, n) of ``imgs``."""
        with torch.no_grad():
            return self.vq.encode_imgs(imgs)

    @torch.no_grad()
    def generate(self, imgs: torch.Tensor | None = None, batch: int = 1,
                 num_masked: int = 200, timesteps: int = 18,
                 filter_p: float = 0.9, approx_topk: bool = False, *,
                 seeds=None, noise=None) -> torch.Tensor:
        """Images (b, 3, H, W) decoded from ids sampled from scratch
        (``imgs=None``: ``batch`` rows, every position re-maskable) or by
        inpainting the first ``num_masked`` positions of ``imgs``' tokens.
        ``seeds``: one int per row (default 0, 1, ...). ``noise``: per-step
        Gumbel draws, (b, n, k) in exact mode and (b, n, C) in approx mode."""
        t = self.bidirectional_transformer
        dev = t.pos_enc.device
        n = self.num_patches
        if imgs is None:
            ids = torch.full((batch, n), self.mask_token_id, dtype=torch.long,
                             device=dev)
            base_mask = torch.ones(batch, n, dtype=torch.bool, device=dev)
        else:
            batch = imgs.shape[0]
            ids = self.vq.encode_imgs(imgs).long()
            base_mask = (torch.arange(n, device=dev) < num_masked).expand(batch, n)
        seeds = row_seeds(seeds, batch)
        k = num_kept(t.linear.weight.shape[0], filter_p)
        gens = ([torch.Generator(device=dev).manual_seed(int(s)) for s in seeds]
                if not approx_topk and noise is None else None)
        scores = torch.zeros(batch, n, device=dev)
        epilogue = (sample_epilogue_fused if self.kernels
                    else _sample_epilogue_reference)
        with weights_quantized_once(t):
            for step, (num_to_mask, temperature) in enumerate(
                    decode_schedule(timesteps, num_masked)):
                mask = lowest_score_mask(scores, num_to_mask) & base_mask
                logits = t(torch.where(mask, self.mask_token_id, ids))
                if approx_topk and noise is None:
                    pred, new_scores = epilogue(
                        logits, p=filter_p, temperature=temperature,
                        seeds=seeds.to(dev), step=step)
                else:
                    nz = noise[step] if noise is not None else torch.stack(
                        [gumbel((n, k), g, dev) for g in gens])
                    pred, chosen = sample_topk_filtered(
                        logits, filter_p, temperature, approx=approx_topk,
                        noise=nz)
                    new_scores = torch.exp(
                        chosen - torch.logsumexp(logits.float(), dim=-1))
                ids = torch.where(mask, pred.long(), ids)
                scores = torch.where(mask, new_scores, 1.0)
        return self.vq.decode_indices(ids)

