"""Trainer of the seq2seq Transformer.

Counterpart of ``attention_models_tpu/training/transformer_trainer.py``:
teacher forcing on (src, [START] + tgt[:-1]) against tgt, a cross-entropy
over the fp32 logits that ignores PAD (0) and the token accuracy over the
same positions, AdamW through ``build_optimizer`` with no-decay grouping,
the config's schedule over optimizer steps, the EMA with
``training.ema_decay``. A micro-step is the JAX step: the loss (the
positional encoding's dropout active, drawn from the trainer's generator),
``autograd.grad`` over the parameters, ``opt.step`` (accumulation,
clipping, AdamW, the schedule), the EMA. ``evaluate`` keeps the real rows'
per-sample CE and accuracy of the validation set (a ragged tail batch
padded, its padding sliced off) and logs their means; ``on_sample``
decodes the first validation batch with ``Transformer.generate`` (Gumbel
sampling at temperature 1 from the trainer's generator) and logs the token
match and the exact-sequence match against the targets.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F

from attention_models_torch.training.base_trainer import BaseTrainer
from attention_models_torch.training.optim import build_optimizer
from attention_models_torch.training.schedules import build_schedule

log = logging.getLogger(__name__)

PAD, START, END = 0, 1, 2


def shift_right(tgt: np.ndarray) -> np.ndarray:
    """The teacher-forcing decoder input: [START] + tgt[:-1] per row."""
    out = np.empty_like(tgt)
    out[:, 0] = START
    out[:, 1:] = tgt[:, :-1]
    return out


def ce_and_acc(logits: torch.Tensor, labels: torch.Tensor,
               per_sample: bool = False):
    """The PAD-masked cross-entropy of the fp32 logits and the token
    accuracy, over all rows (scalars) or a row at a time (``per_sample``,
    (b,) each)."""
    valid = (labels != PAD).float()
    ce = F.cross_entropy(logits.float().flatten(0, -2),
                         labels.long().flatten(),
                         reduction="none").reshape(labels.shape)
    acc = (logits.argmax(-1) == labels).float()
    if per_sample:
        n = valid.sum(-1).clamp_min(1.0)
        return (ce * valid).sum(-1) / n, (acc * valid).sum(-1) / n
    n = valid.sum().clamp_min(1.0)
    return (ce * valid).sum() / n, (acc * valid).sum() / n


class TransformerTrainer(BaseTrainer):
    def __init__(self, cfg, model, dataloaders, device=None):
        super().__init__(cfg, model, dataloaders, device)
        self.schedule = build_schedule(cfg, self.num_iters_per_epoch)
        self.model = model.to(self.device).train()
        self.opt = build_optimizer(cfg, self.schedule, self.model,
                                   no_decay_grouping=True)
        self.params = self.opt.param_groups[0]["params"]
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
    def ids(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr, np.int64), device=self.device)

    def batch(self, src, tgt):
        """(src, decoder input, labels) on the device from a loader batch."""
        tgt = np.asarray(tgt)
        return self.ids(src), self.ids(shift_right(tgt)), self.ids(tgt)

    def train_step(self, src: torch.Tensor, tgt_in: torch.Tensor,
                   labels: torch.Tensor) -> dict:
        """One micro-step. Returns the loss and the token accuracy as 0-d
        tensors (no synchronisation)."""
        logits = self.model(src, tgt_in, deterministic=False,
                            generator=self.generator)
        loss, acc = ce_and_acc(logits, labels)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        self.opt.step(grads)
        if self.ema:
            self.ema_update(self.model)
        return {"loss": loss.detach(), "acc": acc.detach()}

    def train(self) -> None:
        start_epoch, skip = self.resume_position()
        for epoch in range(start_epoch, self.num_epoch):
            # the order of an epoch is a function of its index: a resumed
            # run replays the uninterrupted run's batches
            self.train_dl.set_epoch(epoch)
            for it, (src, tgt) in enumerate(self.train_dl):
                if epoch == start_epoch and it < skip:
                    continue  # mid-epoch resume: already-trained batches
                metrics = self.train_step(*self.batch(src, tgt))
                self.run_cadence(metrics)
                if self.check_preemption():
                    return
        self.finish()

    def on_eval(self) -> None:
        self.evaluate()

    @torch.no_grad()
    def on_sample(self) -> dict | None:
        """The first validation batch decoded through the EMA weights:
        ``sample_token_match`` (generated tokens equal to the target's, over
        its non-PAD positions) and ``sample_exact_match`` (rows equal at
        every such position), logged and returned."""
        for src, tgt in self.val_dl:
            src_p, tgt_p, n = self.pad_batch(np.asarray(src), np.asarray(tgt))
            max_len = int(tgt_p.shape[1])
            self.model.eval()
            with self.eval_weights(self.model):
                tokens = self.model.generate(
                    self.ids(src_p), max_len, START, END,
                    generator=self.generator)
            self.model.train()
            gen = tokens.cpu().numpy()[:n, 1:max_len + 1]
            ref = np.asarray(tgt_p)[:n]
            valid = ref != PAD
            m = {"sample_token_match": float(((gen == ref) & valid).sum()
                                             / max(valid.sum(), 1)),
                 "sample_exact_match": float(np.mean(
                     ((gen == ref) | ~valid).all(axis=1)))}
            self.metrics.log(m, self.global_step)
            return m
        return None

    @torch.no_grad()
    def evaluate(self) -> dict | None:
        """``val_loss`` and ``val_token_acc`` over the validation set
        (deterministic, through the EMA weights), logged and returned."""
        ce, acc = [], []
        self.model.eval()
        with self.eval_weights(self.model):
            for src, tgt in self.val_dl:
                src_p, tgt_p, n = self.pad_batch(np.asarray(src),
                                                 np.asarray(tgt))
                s, t_in, labels = self.batch(src_p, tgt_p)
                ce_b, acc_b = ce_and_acc(self.model(s, t_in), labels,
                                         per_sample=True)
                ce.append(ce_b.cpu().numpy()[:n])
                acc.append(acc_b.cpu().numpy()[:n])
        self.model.train()
        log.info("Validation finished!")
        if not ce:
            return None
        m = {"val_loss": float(np.mean(np.concatenate(ce))),
             "val_token_acc": float(np.mean(np.concatenate(acc)))}
        self.metrics.log(m, self.global_step)
        return m
