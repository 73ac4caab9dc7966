"""Classification trainer of the ViT and the ViT-MoE.

Counterpart of ``attention_models_tpu/training/vit_trainer.py::VitTrainer``:
AdamW through ``build_optimizer`` over every parameter (optax ``adamw``
without a mask decays them all), the HF cosine with warmup over the horizon
in optimizer steps (``num_epochs`` x iterations per epoch, which counts
effective batches; the config's ``decay_steps`` is not read, as in JAX),
softmax cross-entropy on the fp32 logits with integer labels, and the
batch accuracy of the logits the step computed. A micro-step is the JAX
step: the loss (dropout active, drawn from the trainer's generator),
``autograd.grad`` over the parameters (a parameter the loss does not
reach, as ViT-MoE's unweighted output-MoE gates ``W_d.0``, gets a zero
gradient, as JAX's autodiff gives it, so AdamW still decays it),
``opt.step`` (accumulation, clipping, AdamW, the schedule), the EMA with
``training.ema_decay``.
``evaluate`` pads a ragged tail batch (``pad_batch``), keeps the real rows'
per-sample correctness and logs their mean, through the EMA weights when
there is an EMA.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F

from attention_models_torch.training.base_trainer import BaseTrainer
from attention_models_torch.training.optim import build_optimizer
from attention_models_torch.training.schedules import cosine_with_warmup

log = logging.getLogger(__name__)


class VitTrainer(BaseTrainer):
    def __init__(self, cfg, model, dataloaders, device=None):
        super().__init__(cfg, model, dataloaders, device)
        self.schedule = cosine_with_warmup(
            float(cfg.optimizer.params.learning_rate),
            int(cfg.lr_scheduler.params.warmup_steps),
            self.num_epoch * self.num_iters_per_epoch)
        self.model = model.to(self.device).train()
        self.params = list(self.model.parameters())
        self.opt = build_optimizer(cfg, self.schedule, self.params)
        self.ema_init(self.model)
        self.maybe_resume()

    # -- state ---------------------------------------------------------------
    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "opt": self.opt.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.opt.load_state_dict(state["opt"])

    # -- the step ------------------------------------------------------------
    def labels(self, target) -> torch.Tensor:
        return torch.as_tensor(np.asarray(target), device=self.device).long()

    def train_step(self, img: torch.Tensor, target: torch.Tensor) -> dict:
        """One micro-step on images (b, 3, H, W) and labels (b,). Returns the
        loss and the batch accuracy as 0-d tensors (no synchronisation)."""
        logits = self.model(img, deterministic=False,
                            generator=self.generator)
        loss = F.cross_entropy(logits.float(), target)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        acc = (logits.detach().argmax(-1) == target).float().mean()
        self.opt.step(grads)
        if self.ema:
            self.ema_update(self.model)
        return {"loss": loss.detach(), "acc": acc}

    def train(self) -> None:
        start_epoch, skip = self.resume_position()
        for epoch in range(start_epoch, self.num_epoch):
            # the order of an epoch is a function of its index: a resumed
            # run replays the uninterrupted run's batches
            self.train_dl.set_epoch(epoch)
            for it, (img, target) in enumerate(self.train_dl):
                if epoch == start_epoch and it < skip:
                    continue  # mid-epoch resume: already-trained batches
                metrics = self.train_step(self.to_device(img),
                                          self.labels(target))
                self.run_cadence(metrics)
                if self.check_preemption():
                    return
        self.finish()

    def on_eval(self) -> None:
        self.evaluate()

    @torch.no_grad()
    def evaluate(self) -> float | None:
        """Validation accuracy over the whole validation set, logged as
        ``val_acc`` and returned (None for an empty set)."""
        correct = []
        self.model.eval()
        with self.eval_weights(self.model):
            for img, target in self.val_dl:
                img_p, tgt_p, n = self.pad_batch(img, np.asarray(target))
                pred = self.model(self.to_device(img_p)).argmax(-1)
                hit = pred.cpu().numpy() == np.asarray(tgt_p)
                correct.append(hit[:n].astype(np.float32))
        self.model.train()
        log.info("Validation finished!")
        if not correct:
            return None
        acc = float(np.mean(np.concatenate(correct)))
        self.metrics.log({"val_acc": acc}, self.global_step)
        return acc
