"""Trainer dispatch: the ViTVQGAN GAN trainer, the MaskGIT trainer and the
classifiers' (ViT and ViT-MoE); Muse and Parti raise until their trainers
are ported (counterpart of ``attention_models_tpu/training/build_trainer.py``)."""

from __future__ import annotations


def build_trainer(cfg, model, dataloaders, device=None):
    if cfg.model.get("quant"):
        raise ValueError("model.quant is inference-only; unset it for "
                         "training")
    name = cfg.model.name
    if name == "vitvqgan":
        from attention_models_torch.training.vqgan_trainer import VQGANTrainer

        return VQGANTrainer(cfg, model, dataloaders, device)
    if name == "maskgit":
        from attention_models_torch.training.generator_trainers import (
            MaskGitTrainer,
        )

        return MaskGitTrainer(cfg, model, dataloaders, device)
    if name in ("vit", "vit_moe"):
        from attention_models_torch.training.vit_trainer import VitTrainer

        return VitTrainer(cfg, model, dataloaders, device)
    if name in ("muse", "parti"):
        raise NotImplementedError(
            f"no trainer for model {name!r} in the port yet: Muse's and "
            f"Parti's trainers follow Parti serving (ROADMAP A.8)")
    raise NotImplementedError(f"no trainer for model {name!r} in the port "
                              f"yet")
