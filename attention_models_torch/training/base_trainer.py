"""Base trainer, single device.

Counterpart of ``attention_models_tpu/training/base_trainer.py`` without the
mesh: the cadences of the ``experiment.*`` keys (save / sample / eval / log,
0 disables one), the optimizer-step counter, a step timer logging
``step_time_ms`` / ``imgs_per_sec``, full-state checkpoints with resume
(mid-epoch included), a checkpoint at the next step boundary on SIGTERM,
an EMA of the trainable weights (``training.ema_decay``) and ``pad_batch``.

Subclasses build their modules and optimizers, then call ``maybe_resume``,
and implement ``state_dict`` / ``load_state_dict`` over their own parts,
``train_step`` and ``evaluate``. ``tensor_parallel``, ``sequence_parallel``,
``pipeline_parallel`` or ``fsdp`` above 1 raise: parallelism is slice 10 of
the port. ``training.profile_step`` raises too (not ported yet).
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import time

import numpy as np
import torch

from attention_models_torch.ops.dispatch import resolve_device
from attention_models_torch.utils.checkpoint import CheckpointManager
from attention_models_torch.utils.metrics import MetricsWriter

log = logging.getLogger(__name__)


class StepTimer:
    """Counts steps without synchronising; ``stop`` synchronises once per
    logging window and returns the window's per-step average."""

    def __init__(self, device: torch.device, ema: float = 0.9):
        self.device, self._ema = device, ema
        self._avg = self._t0 = None
        self._laps = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._laps = 0

    def lap(self) -> None:
        self._laps += 1

    def stop(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = (time.perf_counter() - self._t0) / max(self._laps, 1)
        self._avg = dt if self._avg is None else (
            self._ema * self._avg + (1 - self._ema) * dt)
        return dt

    @property
    def average(self) -> float | None:
        return self._avg


class BaseTrainer:
    def __init__(self, cfg, model, dataloaders, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model
        self.train_dl, self.val_dl = dataloaders
        self.project_name = cfg.experiment.project_name
        self.exp_name = cfg.experiment.exp_name

        self.global_step = 0
        self.num_epoch = int(cfg.training.num_epochs)
        self.gradient_accumulation_steps = int(
            cfg.training.get("gradient_accumulation_steps", 1) or 1)
        self.batch_size = int(cfg.dataset.params.batch_size)
        self.save_every = int(cfg.experiment.save_every)
        self.sample_every = int(cfg.experiment.sample_every)
        self.log_every = int(cfg.experiment.log_every)
        self.eval_every = int(cfg.experiment.eval_every)
        eff_batch = self.batch_size * self.gradient_accumulation_steps
        self.num_iters_per_epoch = max(
            math.ceil(len(self.train_dl.dataset) / eff_batch), 1)

        for key in ("tensor_parallel", "sequence_parallel",
                    "pipeline_parallel"):
            if int(cfg.training.get(key, 1) or 1) > 1:
                raise NotImplementedError(
                    f"training.{key} > 1: parallelism is not ported yet "
                    f"(slice 10)")
        if cfg.training.get("fsdp", False):
            raise NotImplementedError("training.fsdp: parallelism is not "
                                      "ported yet (slice 10)")
        if cfg.training.get("profile_step") is not None:
            raise NotImplementedError("training.profile_step is not ported "
                                      "yet")

        self.seed = int(cfg.training.get("seed", 42) or 42)
        # the trainer's draws on the device (the GP's eta), checkpointed
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.seed)

        output_folder = (cfg.experiment.get("output_dir")
                         or f"outputs/{self.project_name}")
        self.checkpoint_folder = os.path.join(output_folder, "checkpoints")
        self.image_saved_dir = os.path.join(output_folder, "images")
        os.makedirs(self.checkpoint_folder, exist_ok=True)
        os.makedirs(self.image_saved_dir, exist_ok=True)
        self.metrics = MetricsWriter(output_folder)
        self.ckpt = CheckpointManager(os.path.join(
            self.checkpoint_folder, f"{self.project_name}_{self.exp_name}"))

        self.ema_decay = float(cfg.training.get("ema_decay", 0) or 0)
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError(f"training.ema_decay must be in [0, 1), got "
                             f"{self.ema_decay}")
        self.ema: dict[str, torch.Tensor] = {}

        self._preempt_requested = False
        self._install_preemption_handler()
        self.step_timer = StepTimer(self.device)
        log.info("Train dataset size: %d", len(self.train_dl.dataset))
        log.info("Effective iters/epoch: %d", self.num_iters_per_epoch)

    # -- preemption ----------------------------------------------------------
    def _install_preemption_handler(self) -> None:
        """SIGTERM -> checkpoint and exit at the next step boundary."""
        import signal
        import threading

        if threading.current_thread() is not threading.main_thread():
            return

        def _handler(signum, frame):
            log.warning("signal %d received: checkpointing and exiting at "
                        "the next step boundary", signum)
            self._preempt_requested = True

        signal.signal(signal.SIGTERM, _handler)

    def check_preemption(self) -> bool:
        """Once per step: on a pending SIGTERM save the current state and
        return True so the loop exits; resume continues at this step."""
        if not self._preempt_requested:
            return False
        self.save_ckpt()
        log.warning("preemption checkpoint saved at step %d", self.global_step)
        return True

    # -- cadences ------------------------------------------------------------
    @property
    def opt_step(self) -> int:
        """Optimizer steps: one per ``gradient_accumulation_steps``."""
        return self.global_step // self.gradient_accumulation_steps

    def due(self, every, at_step0: bool = False) -> bool:
        if not every:
            return False
        if not self.global_step:
            return at_step0
        return self.global_step % int(every) == 0

    def resume_position(self) -> tuple[int, int]:
        """(start_epoch, batches_to_skip) for a mid-epoch resume."""
        return divmod(self.global_step, max(len(self.train_dl), 1))

    def on_sample(self) -> None:
        """sample_every hook."""

    def on_eval(self) -> None:
        """eval_every hook."""

    def run_cadence(self, m: dict) -> None:
        """Per-step bookkeeping after ``train_step``: save / sample / eval /
        log, the step timer, the step counter."""
        if self.due(self.save_every):
            # after this step: the checkpoint counts it as done, so a
            # resume continues with the next batch
            self.save_ckpt(self.global_step + 1)
        if self.due(self.sample_every):
            self.on_sample()
        if self.due(self.eval_every):
            self.on_eval()
        if self.due(self.log_every, at_step0=True):
            self.metrics.log(self._train_metrics(m), self.global_step)
        self.tick()
        self.global_step += 1

    def _train_metrics(self, m: dict) -> dict:
        out = {k: float(v) for k, v in m.items()}
        out["lr"] = float(self.schedule(self.opt_step))
        return out

    def tick(self) -> None:
        """Counts the step without synchronising; at the log cadence
        synchronises once and logs the window's per-step time."""
        t = self.step_timer
        if t._t0 is None:
            t.start()
            return
        t.lap()
        if self.log_every and not self.global_step % self.log_every:
            dt = t.stop()
            self.metrics.log({
                "step_time_ms": 1000.0 * dt,
                "step_time_ms_avg": 1000.0 * t.average,
                "imgs_per_sec": self.batch_size / max(t.average, 1e-9),
            }, self.global_step)
            t.start()

    def finish(self) -> None:
        self.metrics.close()
        log.info("Train finished!")

    # -- EMA -----------------------------------------------------------------
    def ema_init(self, module: torch.nn.Module,
                 exclude: tuple[str, ...] = ()) -> None:
        """With ``training.ema_decay``: a copy of ``module``'s parameters
        outside the top-level subtrees ``exclude`` (frozen towers never
        move, so averaging them would only duplicate memory)."""
        if self.ema_decay:
            self.ema = {k: p.detach().clone()
                        for k, p in module.named_parameters()
                        if k.split(".")[0] not in exclude}

    @torch.no_grad()
    def ema_update(self, module: torch.nn.Module) -> None:
        """ema <- d * ema + (1 - d) * params, every micro-step."""
        d = self.ema_decay
        for k, p in module.named_parameters():
            if k in self.ema:
                self.ema[k].mul_(d).add_(p.detach(), alpha=1.0 - d)

    @contextlib.contextmanager
    def eval_weights(self, module: torch.nn.Module):
        """The EMA weights in ``module`` for sampling / eval (the live ones
        without an EMA); the live weights are back on exit."""
        if not self.ema:
            yield module
            return
        params = dict(module.named_parameters())
        live = {k: params[k].detach().clone() for k in self.ema}
        with torch.no_grad():
            for k, e in self.ema.items():
                params[k].copy_(e)
        try:
            yield module
        finally:
            with torch.no_grad():
                for k, v in live.items():
                    params[k].copy_(v)

    # -- helpers -------------------------------------------------------------
    def to_device(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr, np.float32), device=self.device)

    def pad_batch(self, *arrays):
        """Pad a ragged eval tail batch to the batch size by repeating its
        last element; returns (*padded, n_real)."""
        n = int(np.asarray(arrays[0]).shape[0])
        if n >= self.batch_size:
            return (*arrays, n)
        out = []
        for a in arrays:
            a = np.asarray(a)
            pad = np.repeat(a[-1:], self.batch_size - n, axis=0)
            out.append(np.concatenate([a, pad], 0))
        return (*out, n)

    def log_image_grid(self, images, path: str, nrow: int = 6) -> None:
        from attention_models_torch.utils.metrics import save_image_grid

        save_image_grid(np.asarray(images, np.float32), path, nrow=nrow)

    def fid_features(self, imgs) -> np.ndarray:
        """(b, 512) pooled VGG16 features for the eval FID, from a tower
        with a fixed seed-0 init, so values compare across evals and runs
        of the port."""
        from attention_models_torch.training.losses import LPIPS
        from attention_models_torch.utils.eval_metrics import vgg_fid_features

        if getattr(self, "_fid_tower", None) is None:
            tower = LPIPS().reset_parameters(torch.Generator().manual_seed(0))
            self._fid_tower = tower.vgg.to(self.device).eval()
        with torch.no_grad():
            return vgg_fid_features(self._fid_tower,
                                    self.to_device(imgs)).cpu().numpy()

    # -- checkpoints ---------------------------------------------------------
    def state_dict(self) -> dict:
        raise NotImplementedError

    def load_state_dict(self, state: dict) -> None:
        raise NotImplementedError

    def save_ckpt(self, steps_done: int | None = None) -> None:
        """The full state after ``steps_done`` micro-steps (default: the
        step counter), under that number."""
        step = self.global_step if steps_done is None else steps_done
        self.ckpt.save(step, {**self.state_dict(), "step": step,
                              "ema": self.ema,
                              "generator": self.generator.get_state()})

    def maybe_resume(self) -> None:
        """Full-state resume from ``experiment.resume_path_from_checkpoint``
        or, with ``experiment.auto_resume``, from this run's own latest."""
        path = self.cfg.experiment.get("resume_path_from_checkpoint")
        mgr = None
        if path:
            if not os.path.isdir(path):
                raise FileNotFoundError(
                    f"experiment.resume_path_from_checkpoint={path!r} is not "
                    f"an existing checkpoint directory")
            mgr = CheckpointManager(path)
        elif (self.cfg.experiment.get("auto_resume", False)
              and self.ckpt.latest_step() is not None):
            mgr = self.ckpt
        if mgr is None:
            return
        state = mgr.restore(map_location=self.device)
        if state is None:
            return
        self.load_state_dict(state)
        self.global_step = int(state["step"])
        self.ema = state["ema"]
        self.generator.set_state(state["generator"].cpu())
        log.info("resumed at step %d", self.global_step)

    def train(self):
        raise NotImplementedError

    def evaluate(self):
        raise NotImplementedError
