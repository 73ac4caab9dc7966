"""GAN trainer of the image tokenizers: the ViTVQGAN and the CNN VQGAN.

Counterpart of ``attention_models_tpu/training/vqgan_trainer.py``, with the
same step structure (``VQGANTrainer.train_step`` there):

1. ONE generator forward serves both phases;
2. D phase on ``rec.detach()``: hinge loss + WGAN-GP; the BatchNorm
   statistics advance through fake, then real (train mode); the GP runs the
   discriminator in eval mode with the statistics from before the step;
3. the D update;
4. G phase on the same ``rec`` against the updated D, in eval mode with the
   new statistics: codebook + adv_w * adv + per_w * LPIPS + lap_w * L1 + L2;
5. backward into the generator parameters only (``autograd.grad`` over
   them: the G loss leaves nothing on D's parameters);
6. the EMA of the generator every micro-step, with ``training.ema_decay``.

The generator computes in the model's compute dtype (bf16 with
``mixed_precision: bf16``) over fp32 parameters; the discriminator and the
LPIPS tower run in fp32. Optimizers follow optax (``training/optim.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from attention_models_torch.models.discriminator import NLayerDiscriminator
from attention_models_torch.training.base_trainer import BaseTrainer
from attention_models_torch.training.losses import (
    LPIPS,
    g_nonsaturating_loss,
    gradient_penalty,
    hinge_d_loss,
)
from attention_models_torch.training.optim import build_optimizer
from attention_models_torch.training.schedules import timm_cosine


class VQGANTrainer(BaseTrainer):
    def __init__(self, cfg, model, dataloaders, device=None):
        super().__init__(cfg, model, dataloaders, device)
        lr = float(cfg.optimizer.params.learning_rate)
        warmup = int(cfg.lr_scheduler.params.warmup_steps)
        decay = cfg.lr_scheduler.params.get("decay_steps")
        total_iters = int(decay) if decay else (
            self.num_epoch * self.num_iters_per_epoch)
        self.schedule = timm_cosine(lr, total_iters, warmup)

        # seeded inits of G, D and the LPIPS tower, in that order, on the
        # CPU; then everything moves to the device
        gen = torch.Generator().manual_seed(self.seed)
        self.model = model.reset_parameters(gen).to(self.device).train()
        self.discr = NLayerDiscriminator(input_nc=3, ndf=64, n_layers=3)
        self.discr = self.discr.reset_parameters(gen).to(self.device)
        self.lpips = LPIPS().reset_parameters(gen).to(self.device).eval()
        self.lpips.requires_grad_(False)

        self.per_loss_weight = float(cfg.losses.per_loss_weight)
        self.adv_loss_weight = float(cfg.losses.adv_loss_weight)
        self.logit_laplace_weight = float(cfg.losses.logit_laplace_weight)

        self.g_params = list(self.model.parameters())
        self.d_params = list(self.discr.parameters())
        self.g_opt = build_optimizer(cfg, self.schedule, self.g_params)
        self.d_opt = build_optimizer(cfg, self.schedule, self.d_params)
        self.ema_init(self.model)
        self.maybe_resume()

    # -- state ---------------------------------------------------------------
    def state_dict(self) -> dict:
        return {"g": self.model.state_dict(), "d": self.discr.state_dict(),
                "g_opt": self.g_opt.state_dict(),
                "d_opt": self.d_opt.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["g"])
        self.discr.load_state_dict(state["d"])
        self.g_opt.load_state_dict(state["g_opt"])
        self.d_opt.load_state_dict(state["d_opt"])

    # -- the step ------------------------------------------------------------
    def train_step(self, img: torch.Tensor,
                   eta: torch.Tensor | None = None) -> dict:
        """One micro-step on a batch (b, 3, H, W) fp32 in [0, 1]; ``eta``
        (b, 1, 1, 1) is the GP's interpolation weight (drawn from the
        trainer's generator when None). Returns the losses as 0-d tensors
        (no synchronisation)."""
        rec, codebook_loss = self.model(img)
        fake_in = rec.detach().float()

        # D phase: the GP first, in eval mode with the statistics from
        # before this step; then fake and real in train mode, which advance
        # them in that order
        self.discr.eval()
        gp = gradient_penalty(self.discr, img, fake_in, eta=eta,
                              generator=self.generator)
        self.discr.train()
        fake = self.discr(fake_in)
        real = self.discr(img)
        d_loss = hinge_d_loss(fake, real) + gp
        d_grads = torch.autograd.grad(d_loss, self.d_params)
        self.d_opt.step(d_grads)

        # G phase on the same rec, against the updated D and its statistics
        self.discr.eval()
        l1 = torch.mean(torch.abs(rec - img))
        l2 = torch.mean((rec - img) ** 2)
        per = torch.mean(self.lpips(rec.float(), img.float()))
        adv = g_nonsaturating_loss(self.discr(rec.float()))
        g_loss = (codebook_loss + self.adv_loss_weight * adv
                  + self.per_loss_weight * per
                  + self.logit_laplace_weight * l1 + l2)
        g_grads = torch.autograd.grad(g_loss, self.g_params,
                                      allow_unused=True)
        self.g_opt.step(g_grads)
        if self.ema:
            self.ema_update(self.model)
        return {k: v.detach() for k, v in (
            ("d_loss", d_loss), ("gp", gp), ("codebook_loss", codebook_loss),
            ("g_loss", adv), ("per_loss", per), ("logit_laplace", l1),
            ("l2_loss", l2))}

    def train(self) -> None:
        start_epoch, skip = self.resume_position()
        for epoch in range(start_epoch, self.num_epoch):
            # the order of an epoch is a function of its index: a resumed
            # run replays the uninterrupted run's batches
            self.train_dl.set_epoch(epoch)
            for it, (imgs, _) in enumerate(self.train_dl):
                if epoch == start_epoch and it < skip:
                    continue  # mid-epoch resume: already-trained batches
                metrics = self.train_step(self.to_device(imgs))
                self.run_cadence(metrics)
                if self.check_preemption():
                    return
        self.finish()

    def on_sample(self) -> None:
        self.evaluate()

    def _train_metrics(self, m: dict) -> dict:
        lr = float(self.schedule(self.opt_step))
        return {"g_lr": lr, "d_lr": lr, **{k: float(v) for k, v in m.items()}}

    @torch.no_grad()
    def evaluate(self) -> None:
        """Up to 10 validation batches: PSNR, the VGG FID (with
        ``training.eval_fid``, default on) and reconstruction grids, with
        the EMA weights when there is an EMA."""
        from attention_models_torch.utils.eval_metrics import fid_score, psnr

        eval_fid = bool(self.cfg.training.get("eval_fid", True))
        psnrs, real_feats, rec_feats = [], [], []
        self.model.eval()
        with self.eval_weights(self.model):
            for i, (img, _) in enumerate(self.val_dl):
                if i == 10:
                    break
                img_p, n = self.pad_batch(img)
                rec, _ = self.model(self.to_device(img_p))
                rec = rec.float()[:n].cpu().numpy()
                psnrs.append(psnr(torch.from_numpy(np.clip(rec, 0, 1)),
                                  torch.from_numpy(np.asarray(img))).numpy())
                if eval_fid:
                    real_feats.append(self.fid_features(img))
                    rec_feats.append(self.fid_features(np.clip(rec, 0, 1)))
                pair = np.stack([np.asarray(img), rec], 1)
                self.log_image_grid(pair.reshape(-1, *pair.shape[2:]),
                                    f"{self.image_saved_dir}/step_{i}.png")
        self.model.train()
        if psnrs:
            m = {"val_psnr_db": float(np.mean(np.concatenate(psnrs)))}
            if eval_fid:
                m["val_fid_vgg"] = fid_score(np.concatenate(real_feats),
                                             np.concatenate(rec_feats))
            self.metrics.log(m, self.global_step)
