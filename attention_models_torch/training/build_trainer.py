"""Trainer dispatch: the GAN trainer of the tokenizers (ViTVQGAN and the
CNN VQGAN), the trainers of the generators (MaskGIT, Muse over either
tokenizer, Parti), the classifiers' (ViT and ViT-MoE) and the seq2seq
Transformer's (counterpart of
``attention_models_tpu/training/build_trainer.py``)."""

from __future__ import annotations


def build_trainer(cfg, model, dataloaders, device=None):
    if cfg.model.get("quant"):
        raise ValueError("model.quant is inference-only; unset it for "
                         "training")
    name = cfg.model.name
    if name in ("vitvqgan", "vqgan"):
        from attention_models_torch.training.vqgan_trainer import VQGANTrainer

        return VQGANTrainer(cfg, model, dataloaders, device)
    if name in ("maskgit", "muse", "muse_vqgan", "parti"):
        from attention_models_torch.training import generator_trainers as gt

        trainer = {"maskgit": gt.MaskGitTrainer, "muse": gt.MuseTrainer,
                   "muse_vqgan": gt.MuseTrainer,
                   "parti": gt.PartiTrainer}[name]
        return trainer(cfg, model, dataloaders, device)
    if name in ("vit", "vit_moe"):
        from attention_models_torch.training.vit_trainer import VitTrainer

        return VitTrainer(cfg, model, dataloaders, device)
    if name == "transformer":
        from attention_models_torch.training.transformer_trainer import (
            TransformerTrainer,
        )

        return TransformerTrainer(cfg, model, dataloaders, device)
    raise NotImplementedError(f"no trainer for model {name!r} in the port "
                              f"yet")
