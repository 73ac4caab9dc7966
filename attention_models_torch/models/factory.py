"""build_model(cfg): the config's model.

Counterpart of ``attention_models_tpu/models/factory.py``. The compute
dtype is bf16 over fp32 parameters with ``training.mixed_precision: bf16``,
fp32 otherwise.

- ``vitvqgan``: ``model.transformer`` gives the ViT widths,
  ``dataset.preprocessing.resolution`` the image size, ``codebook`` the
  quantiser. Unplaced and not yet initialised: the trainer seeds and places
  it.
- ``maskgit``: the generator over the ``vitvqgan`` block's tokenizer,
  seeded from ``training.seed``, with the tokenizer checkpoint
  ``vitvqgan.checkpoint`` loaded over its ``vq`` when the file exists,
  placed on ``device`` (None: the card, raising without CUDA; ``"cpu"``
  runs the plain path). ``model.dropout`` is the attention dropout of
  training (the decode is deterministic).
- ``vit``: the ViT classifier, ``model.transformer`` giving its widths and
  ``dataset.preprocessing.resolution`` its image size, seeded from
  ``training.seed`` and placed on ``device`` as ``maskgit`` is.
- ``vit_moe``: the ViT-MoE classifier, built as ``vit`` is, with
  ``model.transformer``'s ``n_experts``, ``sel_experts``,
  ``capacity_factor`` (None: dropless) and ``moe_impl`` (default "auto").
- ``muse``: the text-conditioned generator (``model.decoder`` and
  ``model.encoder`` give its decoder and CLIP widths) over the ``vitvqgan``
  block's tokenizer, seeded, loaded and placed as ``maskgit`` is.
  ``muse_vqgan`` (the CNN tokenizer) raises until slice 7.

``model.quant`` (None, "int8", "int8_wide") is the W8A8 inference mode of
all three (``build_trainer`` refuses it); ``training.remat``,
``training.scan_layers`` and ``training.pipeline_microbatches`` are not
ported yet and raise. Other models raise until their slice is ported.
"""

from __future__ import annotations

import logging
import os

import torch

from attention_models_torch.models.maskgit import MaskGitTransformer
from attention_models_torch.models.muse import MUSE
from attention_models_torch.models.vit import ViT
from attention_models_torch.models.vit_moe import ViTMoE
from attention_models_torch.models.vitvqgan import ViTVQGAN
from attention_models_torch.ops.dispatch import resolve_device

log = logging.getLogger(__name__)


def _dtype(cfg) -> torch.dtype:
    mp = str(cfg.training.get("mixed_precision", "no") or "no")
    return torch.bfloat16 if mp == "bf16" else torch.float32


def _vit_params(node, cfg) -> dict:
    return dict(dim=node.dim, img_size=cfg.dataset.preprocessing.resolution,
                patch_size=node.patch_size, n_heads=node.n_heads,
                d_head=node.d_head, depth=node.depth, mlp_dim=node.mlp_dim,
                dropout=node.dropout)


def _codebook_params(cfg) -> dict:
    return dict(codebook_dim=cfg.codebook.codebook_dim,
                codebook_size=cfg.codebook.codebook_size)


def load_vq_checkpoint(path: str | None) -> dict[str, torch.Tensor] | None:
    """The frozen tokenizer's ``state_dict``: a reference ``VitVQGAN.pt``
    (its keys are the port's), or the port's own VQGANTrainer checkpoint
    (a ``step_<n>.pt`` file or its directory, the newest step; the EMA
    weights over the live ones when it kept an EMA). A missing path warns
    and returns None (the tokenizer keeps its seeded init); a directory of
    another kind (the JAX package's orbax checkpoints) raises."""
    if not path or not os.path.exists(path):
        log.warning("VQ checkpoint %s not found; frozen tokenizer keeps its "
                    "seeded init", path)
        return None
    if os.path.isdir(path):
        from attention_models_torch.utils.checkpoint import CheckpointManager

        if CheckpointManager(path).latest_step() is None:
            raise NotImplementedError(
                f"{path}: orbax checkpoint directories are not ported; give "
                f"a VitVQGAN.pt or a checkpoint of the port's VQGANTrainer")
        ckpt = CheckpointManager(path).restore()
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if "g" in ckpt:  # VQGANTrainer.state_dict() + "ema"
        return {**ckpt["g"], **(ckpt.get("ema") or {})}
    return ckpt.get("state_dict", ckpt)


def _refuse_unported(cfg) -> None:
    for key, on in (
            ("training.remat", cfg.training.get("remat", False)),
            ("training.scan_layers", cfg.training.get("scan_layers", False)),
            ("training.pipeline_microbatches",
             cfg.training.get("pipeline_microbatches") is not None)):
        if on:
            raise NotImplementedError(f"{key} is not ported yet")


def _vq_config(cfg) -> dict:
    return dict(vit_params=_vit_params(cfg.vitvqgan.transformer, cfg),
                codebook_params=_codebook_params(cfg))


def _seeded(model, cfg):
    return model.reset_parameters(
        torch.Generator().manual_seed(int(cfg.training.get("seed", 0))))


def _seeded_on(model, cfg, dev):
    """Seeded from ``training.seed``, the tokenizer checkpoint loaded over
    ``vq`` when it exists, placed on ``dev``."""
    _seeded(model, cfg)
    vq = load_vq_checkpoint(cfg.vitvqgan.get("checkpoint"))
    if vq is not None:
        model.vq.load_state_dict(vq)
    return model.to(dev)


def build_model(cfg, device: str | torch.device | None = None):
    """The config's model; ``device`` places the ``maskgit``, ``muse``,
    ``vit`` and ``vit_moe`` models (the ``vitvqgan`` model is placed by its
    trainer)."""
    name = cfg.model.name
    quant = cfg.model.get("quant")
    if name == "vitvqgan":
        t = cfg.model.transformer
        return ViTVQGAN(vit_params=_vit_params(t, cfg),
                        codebook_params=_codebook_params(cfg),
                        dtype=_dtype(cfg), quant=quant)
    if name == "maskgit":
        dev = resolve_device(device)
        _refuse_unported(cfg)
        m = cfg.model
        model = MaskGitTransformer(
            dim=m.dim, vq_config=_vq_config(cfg),
            vocab_size=cfg.codebook.codebook_size, n_heads=m.n_heads,
            d_head=m.d_head, dec_depth=m.depth, mult=m.mult,
            dropout=float(m.get("dropout", 0.0) or 0.0), dtype=_dtype(cfg),
            quant=quant)
        return _seeded_on(model, cfg, dev)
    if name == "vit":
        dev = resolve_device(device)
        _refuse_unported(cfg)
        t = cfg.model.transformer
        model = ViT(dim=t.dim, image_size=cfg.dataset.preprocessing.resolution,
                    patch_size=t.patch_size, n_heads=t.n_heads,
                    d_head=t.get("d_head", 64), depth=t.depth,
                    mlp_dim=t.mlp_dim, dropout=float(t.dropout),
                    num_classes=t.num_classes, dtype=_dtype(cfg))
        return _seeded(model, cfg).to(dev)
    if name == "vit_moe":
        dev = resolve_device(device)
        _refuse_unported(cfg)
        t = cfg.model.transformer
        cf = t.get("capacity_factor")
        model = ViTMoE(
            dim=t.dim, image_size=cfg.dataset.preprocessing.resolution,
            patch_size=t.patch_size, n_heads=t.n_heads,
            d_head=t.get("d_head", 64), depth=t.depth,
            n_experts=t.n_experts, sel_experts=t.sel_experts,
            dropout=float(t.dropout), num_classes=t.num_classes,
            moe_impl=t.get("moe_impl", "auto"),
            capacity_factor=None if cf is None else float(cf),
            dtype=_dtype(cfg))
        return _seeded(model, cfg).to(dev)
    if name in ("muse", "muse_vqgan"):
        if name == "muse_vqgan" or "vitvqgan" not in cfg:
            raise NotImplementedError(
                "Muse over the CNN VQGAN tokenizer (muse_vqgan) is not ported "
                "yet (port slice 7)")
        dev = resolve_device(device)
        _refuse_unported(cfg)
        d, e = cfg.model.decoder, cfg.model.encoder
        model = MUSE(
            dim=cfg.model.dim, vq_config=_vq_config(cfg),
            max_length=e.max_length, n_heads=d.n_heads, d_head=d.d_head,
            depth=d.depth, mult=d.mult,
            dropout=float(d.get("dropout", 0.0) or 0.0),
            clip_width=e.get("width", 768), clip_layers=e.get("layers", 12),
            clip_heads=e.get("heads", 12), dtype=_dtype(cfg), quant=quant)
        return _seeded_on(model, cfg, dev)
    raise NotImplementedError(f"model {name!r} is not ported yet")
