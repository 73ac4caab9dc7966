"""Learning-rate schedules: step (an optimizer step count) -> rate.

Counterpart of ``attention_models_tpu/training/schedules.py``:
- HF ``get_constant_schedule_with_warmup`` / ``get_cosine_schedule_with_
  warmup``: linear warmup from 0, then constant, or cosine to 0 over
  ``decay_steps``;
- timm ``CosineLRScheduler(t_initial, warmup_t, warmup_lr_init=1e-6,
  lr_min=5e-5)``: linear warmup from ``warmup_lr_init``, then cosine to
  ``lr_min`` (the VQGAN trainer's).
Plain Python floats; the optimizer reads them once per step.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def constant_with_warmup(base_lr: float, warmup_steps: int) -> Schedule:
    """``step / warmup`` while ``step < warmup``, else 1 (so warmup 0 is
    the full rate from step 0)."""

    def fn(step):
        warm = step / max(warmup_steps, 1) if step < warmup_steps else 1.0
        return base_lr * warm

    return fn


def cosine_with_warmup(base_lr: float, warmup_steps: int,
                       decay_steps: int) -> Schedule:
    """Linear warmup from 0, then optax's ``cosine_decay_schedule`` from
    base_lr to 0 over ``decay_steps - warmup_steps`` steps."""
    span = max(decay_steps - warmup_steps, 1)

    def fn(step):
        if step < warmup_steps:
            return base_lr * step / warmup_steps
        t = min(step - max(warmup_steps, 0), span) / span
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * t))

    return fn


def timm_cosine(base_lr: float, t_initial: int, warmup_t: int,
                warmup_lr_init: float = 1e-6,
                lr_min: float = 5e-5) -> Schedule:
    """timm CosineLRScheduler (one cycle, no restarts)."""

    def fn(step):
        if step < warmup_t:
            return warmup_lr_init + (base_lr - warmup_lr_init) * min(
                step / max(warmup_t, 1), 1.0)
        t = min(max((step - warmup_t) / max(t_initial - warmup_t, 1), 0.0),
                1.0)
        return lr_min + 0.5 * (base_lr - lr_min) * (1 + math.cos(math.pi * t))

    return fn


def build_schedule(cfg, num_iters_per_epoch: int) -> Schedule:
    """From the config's ``lr_scheduler.name`` + ``params``; a null
    ``decay_steps`` means epochs * iters per epoch."""
    name = cfg.lr_scheduler.get("name", "cosine_with_warmup")
    p = cfg.lr_scheduler.params
    base_lr = float(cfg.optimizer.params.learning_rate)
    warmup = int(p.warmup_steps)
    decay = p.get("decay_steps")
    if not decay:
        decay = int(cfg.training.num_epochs) * num_iters_per_epoch
    if name == "constant_with_warmup":
        return constant_with_warmup(base_lr, warmup)
    if name == "cosine_with_warmup":
        return cosine_with_warmup(base_lr, warmup, int(decay))
    if name == "timm_cosine":
        return timm_cosine(base_lr, int(decay), warmup)
    raise ValueError(f"unknown lr scheduler {name!r}")
