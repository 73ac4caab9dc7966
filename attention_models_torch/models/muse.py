"""Muse: text-conditioned masked token generation with classifier-free
guidance, over the frozen tokenizer's token grid (the ViTVQGAN's, or the
CNN VQGAN's 16 x 16 under ``muse_vqgan``).

Counterpart of ``attention_models_tpu/models/muse.py``: the forward of
``BidirectionalDecoder`` (logits, or with ``targets`` the training loss),
``MUSE.encode_texts``, ``MUSE.generate`` and the training step
(``forward`` / ``loss_from_indices``). Keys: ``vq.*`` (the
tokenizer, frozen), ``text_encoder.{clip.text_model.*, project_embeds}``
(``models/text_encoder.py``), ``decoder.{token_emb.weight (vocab + 1 rows,
the last the mask token), pos_enc, decoder.layers.{i}, final_norm,
linear.weight (no bias)}``. The embedding table, ``pos_enc`` and the head
are cast to the compute dtype at use, as flax's ``dtype=`` does.

``generate`` keeps the JAX loop step for step: the text embeddings once
(projected) and a null context of zeros like them; per step the
``num_to_mask = max(int(cos(t * pi / 2) * n), 1)`` lowest scores of each row
are masked (any position, every step), then ONE forward over the ids tiled
twice and [text; null] gives the cond and null logits (model dtype). Approx
mode runs the fused epilogue's CFG branch on them (kernel on the card; a
Philox seed per row); exact mode samples the fp32 ``null + s (cond - null)``
with top-k filtered Gumbel noise from one ``torch.Generator`` per row, and
its score is exp(chosen - logsumexp) of that. ``noise`` replaces both with
given per-step Gumbel draws (approx mode then samples the model-dtype
combine through the unfused chain, as the JAX package does off the TPU).
The scores of every position are replaced each step. The final ids are
decoded by the tokenizer. Under ``quant`` every int8 weight is quantized
once per generate (``weights_quantized_once``), as JAX hoists it out of its
scan.

Training keeps the JAX step: the frozen tokenizer's grid, the text tower
(projection included) without gradient, ``random_mask`` with mask-token
inputs and ignore-index targets, each row's text kept when a uniform draw
falls below ``cond_keep_prob`` (0.9; zeros otherwise: the null stream of
CFG), then the decoder with ``targets``: its dropout active unless
``deterministic``, and the mean NLL over the masked positions through
``fused_head_xent`` (no bias) under the JAX gate, the logits' cross-entropy
otherwise. One generator draws the mask, the keep, then the dropout, in
that order; tests hand in the first two (``mask_draws``, ``cond_draws``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from attention_models_torch.models.layers import (
    GammaLayerNorm,
    LayerNorm,
    Linear,
    lecun_normal_,
)
from attention_models_torch.models.maskgit import decode_schedule, row_seeds
from attention_models_torch.models.text_encoder import TextEncoder
from attention_models_torch.models.transformer import Decoder
from attention_models_torch.models.vitvqgan import ViTVQGAN
from attention_models_torch.models.vq_common import (
    build_vq,
    vq_codebook_size,
    vq_num_patches,
)
from attention_models_torch.ops.quant import check_mode, weights_quantized_once
from attention_models_torch.ops.sampling import (
    _sample_epilogue_reference,
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


class BidirectionalDecoder(nn.Module):
    """Token embedding (vocab + 1) + learned positions -> the cross-attention
    ``Decoder`` -> gamma-LN -> no-bias head (W8A8 under "int8" only), or
    with ``targets`` the mean NLL over their non-ignored (-1) positions."""

    def __init__(self, dim: int, codebook_size: int, n_heads: int,
                 d_head: int, depth: int, mult: float, dropout: float,
                 num_patches: int, dtype: torch.dtype | None = None,
                 quant: str | None = None):
        super().__init__()
        self.compute_dtype = dtype
        self.token_emb = nn.Embedding(codebook_size + 1, dim)
        self.pos_enc = nn.Parameter(torch.zeros(1, num_patches, dim))
        self.decoder = Decoder(dim, n_heads, d_head, depth, mult, dropout,
                               quant)
        self.final_norm = GammaLayerNorm(dim)
        self.linear = Linear(dim, codebook_size, bias=False,
                             quant="int8" if quant == "int8" else None)
        self.quant = check_mode(quant)
        self.kernels = True  # the fused head loss

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.linear.weight.dtype

    def forward(self, indices: torch.Tensor, context: torch.Tensor,
                context_mask: torch.Tensor | None = None,
                deterministic: bool = True,
                targets: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Token ids (b, n) and text context (b, t, dim) -> logits
        (b, n, vocab) in the compute dtype; with ``targets`` (b, n) the mean
        NLL instead. The dropout draws from ``generator`` unless
        ``deterministic``."""
        dt = self.dtype
        x = F.embedding(indices.long(), self.token_emb.weight).to(dt)
        x = self.decoder(x + self.pos_enc.to(dt), context, context_mask,
                         deterministic, generator)
        x = self.final_norm(x)
        if targets is None:
            return self.linear(x)
        vocab = self.linear.weight.shape[0]
        if self.quant is None and head_xent_supported(x.shape, x.shape[-1],
                                                      vocab):
            fn = fused_head_xent if self.kernels else _head_xent_loss_reference
            return fn(x, self.linear.weight, targets)
        return cross_entropy_ignore_index(self.linear(x), targets)


class MUSE(nn.Module):
    def __init__(self, dim: int, vq_config: dict, max_length: int = 77,
                 n_heads: int = 8, d_head: int = 64, depth: int = 6,
                 mult: float = 4, dropout: float = 0.0,
                 guidance_scale: float = 3.0, clip_width: int = 768,
                 clip_layers: int = 12, clip_heads: int = 12,
                 dtype: torch.dtype | None = None, quant: str | None = None,
                 cond_keep_prob: float = 0.9):
        super().__init__()
        self.compute_dtype = dtype
        self.quant = check_mode(quant)
        self.guidance_scale = guidance_scale
        self.cond_keep_prob = float(cond_keep_prob)
        self.text_encoder = TextEncoder(dim, max_length, clip_width,
                                        clip_layers, clip_heads)
        self.vq = build_vq(vq_config, dtype=dtype).requires_grad_(False)
        self.codebook_size = vq_codebook_size(vq_config)
        self.mask_token_id = self.codebook_size
        self.num_patches = vq_num_patches(vq_config)
        self.decoder = BidirectionalDecoder(
            dim, self.codebook_size, n_heads, d_head, depth, mult, dropout,
            self.num_patches, dtype, quant)
        self.kernels = True  # the sampling epilogue

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.dtype

    use_kernels = ViTVQGAN.use_kernels  # the tokenizer's modules included

    def reset_parameters(self, generator: torch.Generator) -> "MUSE":
        """The JAX package's inits: the tokenizer's own, lecun-normal Linear
        weights and zero biases, unit gammas and LayerNorm ones/zeros,
        google-maskgit's normal(0.02) truncated at 2 sd for the token
        embedding and the head, normal(1.0) positions; CLIP's token
        embedding normal(1 / sqrt(width)) (flax ``Embed``) and positions
        normal(0.01)."""
        self.vq.reset_parameters(generator)
        dec, emb = self.decoder, self.text_encoder.clip.text_model.embeddings
        with torch.no_grad():
            for m in (*self.text_encoder.modules(), *dec.modules()):
                if isinstance(m, nn.Linear) and m is not dec.linear:
                    lecun_normal_(m.weight, generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                elif isinstance(m, GammaLayerNorm):
                    m.gamma.fill_(1.0)
            for p in (dec.token_emb.weight, dec.linear.weight):
                nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04,
                                      generator=generator)
            dec.pos_enc.normal_(0.0, 1.0, generator=generator)
            width = emb.token_embedding.weight.shape[1]
            emb.token_embedding.weight.normal_(0.0, width ** -0.5,
                                               generator=generator)
            emb.position_embedding.weight.normal_(0.0, 0.01,
                                                  generator=generator)
        return self

    def encode_texts(self, text_ids: torch.Tensor) -> torch.Tensor:
        """Token ids (b, t) -> projected text embeddings (b, t, dim)."""
        return self.text_encoder(text_ids, self.dtype)

    # -- training ------------------------------------------------------------
    def encode_to_indices(self, imgs: torch.Tensor) -> torch.Tensor:
        """The frozen tokenizer's token grid (b, n) of ``imgs``."""
        with torch.no_grad():
            return self.vq.encode_imgs(imgs)

    def forward(self, text_ids: torch.Tensor, imgs: torch.Tensor, *,
                deterministic: bool = False,
                generator: torch.Generator | None = None, mask_draws=None,
                cond_draws=None) -> torch.Tensor:
        """The training loss of text ids (b, t) and images (b, 3, H, W)."""
        return self.loss_from_indices(
            text_ids, self.encode_to_indices(imgs),
            deterministic=deterministic, generator=generator,
            mask_draws=mask_draws, cond_draws=cond_draws)

    def loss_from_indices(self, text_ids: torch.Tensor,
                          indices: torch.Tensor, *,
                          deterministic: bool = False,
                          generator: torch.Generator | None = None,
                          mask_draws=None, cond_draws=None) -> torch.Tensor:
        """The training loss from token grids (b, n): ``mask_draws`` = (t
        (b,), rand (b, n)) and ``cond_draws`` (b,) replace the mask's and
        the keep's draws from ``generator``."""
        with torch.no_grad():
            text = self.encode_texts(text_ids)
        b, n = indices.shape
        dev = indices.device
        mask = random_mask(b, n, generator=generator, draws=mask_draws,
                           device=dev)
        inputs, targets = mask_fill_inputs_and_targets(
            indices.long(), mask, self.mask_token_id)
        u = (torch.rand(b, generator=generator, device=dev)
             if cond_draws is None else
             torch.as_tensor(cond_draws, dtype=torch.float32, device=dev))
        text = text * (u < self.cond_keep_prob)[:, None, None].to(text.dtype)
        return self.decoder(inputs, text, deterministic=deterministic,
                            targets=targets, generator=generator)

    @torch.no_grad()
    def generate(self, text_ids: torch.Tensor, timesteps: int = 18,
                 filter_p: float = 0.9, guidance_scale: float | None = None,
                 approx_topk: bool = False, *, seeds=None,
                 noise=None) -> torch.Tensor:
        """Images (b, 3, H, W) for text ids (b, t). ``seeds``: one int per
        row (default 0, 1, ...). ``noise``: per-step Gumbel draws, (b, n, k)
        in exact mode and (b, n, C) in approx mode."""
        gs = self.guidance_scale if guidance_scale is None else guidance_scale
        dec = self.decoder
        dev = dec.pos_enc.device
        b, n = text_ids.shape[0], self.num_patches
        seeds = row_seeds(seeds, b)
        k = num_kept(self.codebook_size, filter_p)
        gens = ([torch.Generator(device=dev).manual_seed(int(s)) for s in seeds]
                if not approx_topk and noise is None else None)
        epilogue = (sample_epilogue_fused if self.kernels
                    else _sample_epilogue_reference)
        with weights_quantized_once(self):
            text = self.encode_texts(torch.as_tensor(text_ids, device=dev))
            both = torch.cat([text, torch.zeros_like(text)])
            ids = torch.full((b, n), self.mask_token_id, dtype=torch.long,
                             device=dev)
            scores = torch.zeros(b, n, device=dev)
            for step, (num_to_mask, temperature) in enumerate(
                    decode_schedule(timesteps, n)):
                mask = lowest_score_mask(scores, num_to_mask)
                ids = torch.where(mask, self.mask_token_id, ids)
                cond, null = dec(ids.repeat(2, 1), both).chunk(2)
                if approx_topk and noise is None:
                    pred, scores = epilogue(
                        cond, null, guidance_scale=gs, p=filter_p,
                        temperature=temperature, seeds=seeds.to(dev),
                        step=step)
                else:
                    nz = noise[step] if noise is not None else torch.stack(
                        [gumbel((n, k), g, dev) for g in gens])
                    null32 = null.float()
                    scaled = null32 + gs * (cond.float() - null32)
                    pred, chosen = sample_topk_filtered(
                        null + gs * (cond - null) if approx_topk else scaled,
                        filter_p, temperature, approx=approx_topk, noise=nz)
                    scores = torch.exp(
                        chosen - torch.logsumexp(scaled, dim=-1))
                ids = torch.where(mask, pred.long(), ids)
        return self.vq.decode_indices(ids)
