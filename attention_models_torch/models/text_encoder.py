"""CLIP text tower (the frozen conditioning of Muse) and host tokenization.

Counterpart of ``attention_models_tpu/models/text_encoder.py``: token and
position embeddings, pre-LN causal transformer blocks with biased q/k/v/out
projections and a quick-GELU MLP, a final LayerNorm; ``TextEncoder`` adds
the ``project_embeds`` Linear (width -> the generator's dim). Keys are
Hugging Face ``CLIPTextModel``'s under ``clip.`` (``text_model.embeddings.
{token,position}_embedding.weight``, ``text_model.encoder.layers.{i}.
{layer_norm1, self_attn.{q,k,v,out}_proj, layer_norm2, mlp.fc1, mlp.fc2}``,
``text_model.final_layer_norm``), the names ``attention_models_tpu/utils/
torch_convert.py::convert_hf_clip_text`` reads.

The tower computes in the dtype it is given (the generator's), as the JAX
module's ``dtype=``. Its LayerNorms (beta included) run the LayerNorm op;
its attention passes an explicit causal mask, so it runs the plain
``multihead_attention``, as JAX runs XLA there. It takes no ``quant``: the
JAX package never quantizes it.

``tokenize`` is the JAX package's: Hugging Face's CLIP tokenizer when it
imports and its vocabulary is on disk (``local_files_only``), otherwise the
deterministic md5 hash tokenizer (the same ids as JAX's).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from attention_models_torch.models.layers import LayerNorm, Linear
from attention_models_torch.ops.attention import (
    make_causal_mask,
    multihead_attention,
)

CLIP_VOCAB = 49408
CLIP_BOS = 49406
CLIP_EOS = 49407


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _Attention(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.q_proj, self.k_proj = Linear(width, width), Linear(width, width)
        self.v_proj, self.out_proj = Linear(width, width), Linear(width, width)


class _Mlp(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.fc1, self.fc2 = Linear(width, 4 * width), Linear(4 * width, width)


class ClipTextBlock(nn.Module):
    """x + out_proj(causal attention(layer_norm1(x))), then
    x + fc2(quick_gelu(fc1(layer_norm2(x))))."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.layer_norm1 = LayerNorm(width)
        self.self_attn = _Attention(width)
        self.layer_norm2 = LayerNorm(width)
        self.mlp = _Mlp(width)

    def forward(self, x: torch.Tensor,
                causal_mask: torch.Tensor) -> torch.Tensor:
        b, t, width = x.shape
        d_head = width // self.heads
        h = self.layer_norm1(x)
        a = self.self_attn
        q, k, v = (p(h).view(b, t, self.heads, d_head).transpose(1, 2)
                   for p in (a.q_proj, a.k_proj, a.v_proj))
        out = multihead_attention(q, k, v, scale=d_head ** -0.5,
                                  causal_mask=causal_mask)
        x = x + a.out_proj(out.transpose(1, 2).reshape(b, t, width))
        return x + self.mlp.fc2(quick_gelu(self.mlp.fc1(self.layer_norm2(x))))


class _Embeddings(nn.Module):
    def __init__(self, vocab: int, max_length: int, width: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab, width)
        self.position_embedding = nn.Embedding(max_length, width)


class _Encoder(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.layers = nn.ModuleList(ClipTextBlock(width, heads)
                                    for _ in range(layers))


class _TextModel(nn.Module):
    def __init__(self, width, layers, heads, max_length, vocab):
        super().__init__()
        self.embeddings = _Embeddings(vocab, max_length, width)
        self.encoder = _Encoder(width, layers, heads)
        self.final_layer_norm = LayerNorm(width)


class ClipTextModel(nn.Module):
    """openai/clip-vit-large-patch14's text tower by default (width 768,
    12 layers x 12 heads, 77 positions)."""

    def __init__(self, width: int = 768, layers: int = 12, heads: int = 12,
                 max_length: int = 77, vocab_size: int = CLIP_VOCAB):
        super().__init__()
        self.text_model = _TextModel(width, layers, heads, max_length,
                                     vocab_size)

    def forward(self, input_ids: torch.Tensor,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        """Token ids (b, t) -> hidden states (b, t, width) in ``dtype``
        (default: the parameters')."""
        tm = self.text_model
        emb = tm.embeddings
        dt = dtype or emb.token_embedding.weight.dtype
        t = input_ids.shape[1]
        x = F.embedding(input_ids.long(), emb.token_embedding.weight).to(dt)
        x = x + emb.position_embedding.weight[:t].to(dt)
        mask = make_causal_mask(t, t, x.device)
        for block in tm.encoder.layers:
            x = block(x, mask)
        return tm.final_layer_norm(x)


class TextEncoder(nn.Module):
    """The CLIP tower (``clip``) and Muse's biased ``project_embeds``
    Linear(width -> dim) (the JAX module's ``project=True``)."""

    def __init__(self, dim: int, max_length: int = 77, clip_width: int = 768,
                 clip_layers: int = 12, clip_heads: int = 12):
        super().__init__()
        self.clip = ClipTextModel(clip_width, clip_layers, clip_heads,
                                  max_length)
        self.project_embeds = Linear(clip_width, dim)

    def forward(self, input_ids: torch.Tensor,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        return self.project_embeds(self.clip(input_ids, dtype))


_HF_TOKENIZER = None
_HF_TRIED = False


def _try_hf_tokenizer():
    """Hugging Face's CLIP tokenizer when ``transformers`` imports and the
    vocabulary is already on disk; None otherwise (tried once)."""
    global _HF_TOKENIZER, _HF_TRIED
    if _HF_TRIED:
        return _HF_TOKENIZER
    _HF_TRIED = True
    try:
        from transformers import CLIPTokenizer

        _HF_TOKENIZER = CLIPTokenizer.from_pretrained(
            "openai/clip-vit-large-patch14", local_files_only=True)
    except Exception:  # no transformers, or no vocabulary on disk
        _HF_TOKENIZER = None
    return _HF_TOKENIZER


def _hash_token(word: str) -> int:
    h = int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")
    return h % CLIP_BOS  # clear of BOS/EOS


def tokenize(texts: list[str], max_length: int = 77) -> np.ndarray:
    """(b, max_length) int32: BOS, the words' ids, EOS, then EOS padding (the
    CLIP convention)."""
    tok = _try_hf_tokenizer()
    if tok is not None:
        out = tok(texts, return_tensors="np", max_length=max_length,
                  padding="max_length", truncation=True)
        return out["input_ids"].astype(np.int32)
    ids = np.full((len(texts), max_length), CLIP_EOS, np.int32)
    for i, text in enumerate(texts):
        words = text.lower().split()[: max_length - 2]
        row = [CLIP_BOS] + [_hash_token(w) for w in words] + [CLIP_EOS]
        ids[i, : len(row)] = row
    return ids
