"""Trainer dispatch: the ViTVQGAN GAN trainer; other models raise until
their slice is ported (counterpart of
``attention_models_tpu/training/build_trainer.py``)."""

from __future__ import annotations


def build_trainer(cfg, model, dataloaders, device=None):
    from attention_models_torch.training.vqgan_trainer import VQGANTrainer

    if cfg.model.get("quant"):
        raise ValueError("model.quant is inference-only; unset it for "
                         "training")
    name = cfg.model.name
    if name != "vitvqgan":
        raise NotImplementedError(f"no trainer for model {name!r} in the "
                                  f"port yet")
    return VQGANTrainer(cfg, model, dataloaders, device)
