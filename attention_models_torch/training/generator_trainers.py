"""Trainers of the token-space generators: MaskGIT.

Counterpart of ``attention_models_tpu/training/generator_trainers.py``'s
``_GeneratorTrainer`` and ``MaskGitTrainer``: one optimizer over the
trainable parameters with no-decay grouping (``training/optim.py``), the
frozen ``vq`` tokenizer outside it (no moments, never moves), loss =
model(batch), the EMA of the trainable subtrees with
``training.ema_decay``, and evaluation with a fixed-seed validation loss.
A micro-step is the JAX step: the loss (dropout active), ``autograd.grad``
over the trainable parameters, ``opt.step`` (accumulation, clipping, AdamW,
the schedule), the EMA. The trainer's generator (on the device, seeded from
``training.seed``, checkpointed) draws each step's mask, then its dropout.

``training.cache_vq_tokens``: one pass of the frozen tokenizer over the
training set before the first step, kept in host memory and published
atomically to ``<checkpoints>/vq_token_cache.npz`` under a digest of the
tokenizer's weights, the dataset config and the set's extent; a later run
with the same digest reuses it, another re-tokenizes. The transforms must
then be deterministic (``random_flip`` / ``random_crop`` raise). Muse's and
Parti's trainers come with their models (``training/build_trainer.py``).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os

import numpy as np
import torch

from attention_models_torch.training.base_trainer import BaseTrainer
from attention_models_torch.training.optim import build_optimizer
from attention_models_torch.training.schedules import build_schedule

log = logging.getLogger(__name__)


class _GeneratorTrainer(BaseTrainer):
    """The shared loop; subclasses give ``loss`` and ``evaluate``."""

    frozen_subtrees: tuple[str, ...] = ("vq",)

    def __init__(self, cfg, model, dataloaders, device=None):
        super().__init__(cfg, model, dataloaders, device)
        self.schedule = build_schedule(cfg, self.num_iters_per_epoch)
        self.cache_tokens = bool(cfg.training.get("cache_vq_tokens", False))
        if self.cache_tokens:
            pp = cfg.dataset.preprocessing
            if bool(pp.get("random_flip")) or bool(pp.get("random_crop")):
                raise ValueError(
                    "training.cache_vq_tokens requires deterministic "
                    "transforms: disable dataset.preprocessing.random_flip/"
                    "random_crop (a cached token grid would freeze one "
                    "augmentation draw for every epoch)")
        self.model = model.to(self.device).train()
        self.opt = build_optimizer(cfg, self.schedule, self.model,
                                   frozen_subtrees=self.frozen_subtrees,
                                   no_decay_grouping=True)
        self.trainable = self.opt.param_groups[0]["params"]
        self.ema_init(self.model, exclude=self.frozen_subtrees)
        self.maybe_resume()
        self._tok_cache: np.ndarray | None = None
        if self.cache_tokens:
            self._pretokenize()

    # -- state ---------------------------------------------------------------
    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "opt": self.opt.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.opt.load_state_dict(state["opt"])

    # -- the step ------------------------------------------------------------
    def loss(self, batch: torch.Tensor, tokens: bool, mask_draws=None):
        raise NotImplementedError

    def train_step(self, batch: torch.Tensor, *, tokens: bool = False,
                   mask_draws=None) -> dict:
        """One micro-step on images (b, 3, H, W), or on cached token grids
        (b, n) with ``tokens``; ``mask_draws`` replaces the mask's draws
        (tests). Returns the loss as a 0-d tensor (no synchronisation)."""
        loss = self.loss(batch, tokens, mask_draws)
        grads = torch.autograd.grad(loss, self.trainable, allow_unused=True)
        self.opt.step(grads)
        if self.ema:
            self.ema_update(self.model)
        return {"loss": loss.detach()}

    def train(self) -> None:
        start_epoch, skip = self.resume_position()
        for epoch in range(start_epoch, self.num_epoch):
            # the order of an epoch is a function of its index: a resumed
            # run replays the uninterrupted run's batches
            self.train_dl.set_epoch(epoch)
            batches = (self.train_dl.iter_indices() if self.cache_tokens
                       else self.train_dl)
            for it, batch in enumerate(batches):
                if epoch == start_epoch and it < skip:
                    continue  # mid-epoch resume: already-trained batches
                if self.cache_tokens:
                    x = torch.as_tensor(self._tok_cache[np.asarray(batch)],
                                        device=self.device)
                else:
                    x = self.to_device(batch[0])
                metrics = self.train_step(x, tokens=self.cache_tokens)
                self.run_cadence(metrics)
                if self.check_preemption():
                    return
        self.finish()

    # -- training.cache_vq_tokens --------------------------------------------
    def _vq_cache_digest(self, n_tok: int, n_samples: int) -> str:
        """Fingerprint of the frozen tokenizer's weights, the whole dataset
        config and the set's extent."""
        h = hashlib.sha256()
        for k, v in sorted(self.model.vq.state_dict().items()):
            h.update(k.encode())
            h.update(v.detach().float().cpu().numpy().tobytes())
        h.update(json.dumps(self.cfg.dataset.to_dict(), sort_keys=True,
                            default=str).encode())
        h.update(f"{n_tok}:{n_samples}".encode())
        return h.hexdigest()

    def _pretokenize(self) -> None:
        """The training set's token grids, in sample order: from the
        published cache when its digest matches, else one pass of the
        frozen tokenizer, then published (temporary file, rename)."""
        from attention_models_torch.data.loaders import DataLoader

        ds = self.train_dl.dataset
        n_tok = self.model.num_patches
        cache_file = os.path.join(self.checkpoint_folder, "vq_token_cache.npz")
        digest = self._vq_cache_digest(n_tok, len(ds))
        if os.path.exists(cache_file):
            with np.load(cache_file) as z:
                if str(z["digest"]) == digest:
                    self._tok_cache = z["cache"]
                    log.info("cache_vq_tokens: loaded %s", cache_file)
                    return
            log.warning("cache_vq_tokens: %s is stale (vq weights, dataset "
                        "or preprocessing changed): re-tokenizing",
                        cache_file)
        cache = np.zeros((len(ds), n_tok), np.int32)
        scan = DataLoader(ds, self.batch_size, shuffle=False, drop_last=False)
        order = np.concatenate(list(scan.iter_indices()))
        start = 0
        for img, _ in scan:
            img_p, n = self.pad_batch(img)
            ids = self.model.encode_to_indices(self.to_device(img_p))
            cache[order[start:start + n]] = ids[:n].cpu().numpy()
            start += n
        self._tok_cache = cache
        tmp = cache_file[: -len(".npz")] + ".tmp.npz"
        np.savez(tmp, cache=cache, digest=np.array(digest))
        os.replace(tmp, cache_file)
        log.info("cache_vq_tokens: tokenized %d samples x %d tokens -> %s",
                 len(ds), n_tok, cache_file)

    # -- evaluation ----------------------------------------------------------
    @property
    def eval_fid_on(self) -> bool:
        """The generative FID is opt-in here (``training.eval_fid``)."""
        return bool(self.cfg.training.get("eval_fid", False))

    def eval_generator(self, kind: int, i: int) -> torch.Generator:
        """A fixed generator per (eval kind, batch): evaluations compare
        like with like."""
        return torch.Generator(device=self.device).manual_seed(
            self.seed * 1000 + kind * 100 + i)

    def log_val_loss(self, losses, real_feats=(), gen_feats=()) -> None:
        m = {}
        if losses:
            m["val_loss"] = float(np.mean(losses))
        if len(real_feats) and len(gen_feats):
            from attention_models_torch.utils.eval_metrics import fid_score

            m["val_fid_vgg"] = fid_score(np.concatenate(real_feats),
                                         np.concatenate(gen_feats))
        if m:
            self.metrics.log(m, self.global_step)

    def on_sample(self) -> None:
        self.evaluate()

    def on_eval(self) -> None:
        self.evaluate()


class MaskGitTrainer(_GeneratorTrainer):
    def loss(self, batch, tokens, mask_draws=None):
        fn = self.model.loss_from_indices if tokens else self.model
        return fn(batch, deterministic=False, generator=self.generator,
                  mask_draws=mask_draws)

    @torch.no_grad()
    def evaluate(self) -> None:
        """Up to 11 validation batches through the EMA weights (the live ones
        without an EMA): the deterministic loss under a fixed mask draw, a
        reconstruction grid per batch and, with ``training.eval_fid``, the
        VGG FID of the reconstructions."""
        losses, real_f, gen_f = [], [], []
        self.model.eval()
        with self.eval_weights(self.model):
            for i, (img, _) in enumerate(self.val_dl):
                if i > 10:
                    break
                img_p, n = self.pad_batch(img)
                x = self.to_device(img_p)
                losses.append(float(self.model(
                    x, deterministic=True, generator=self.eval_generator(0, 0))))
                rec = self.model.reconstruct(
                    x, generator=self.eval_generator(1, i))
                rec = rec.float()[:n].cpu().numpy()
                if self.eval_fid_on:
                    real_f.append(self.fid_features(np.asarray(img_p)[:n]))
                    gen_f.append(self.fid_features(np.clip(rec, 0, 1)))
                self.log_image_grid(
                    rec, os.path.join(self.image_saved_dir, f"step_{i}.png"))
        self.model.train()
        self.log_val_loss(losses, real_f, gen_f)
