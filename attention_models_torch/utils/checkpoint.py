"""Full-state checkpoints: one ``torch.save`` file per step.

Counterpart of ``attention_models_tpu/utils/checkpoint.py``'s
``CheckpointManager``: the trainer saves its whole state (step, parameters,
batch statistics, both optimizers with their accumulation buffers, the EMA
and the random generators) as ``<dir>/step_<n>.pt``, written to a temporary
name and renamed, keeping the newest ``max_to_keep``. Loading unpickles,
so load only checkpoints this program wrote.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any

import torch

log = logging.getLogger(__name__)

_NAME = re.compile(r"step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.dir, exist_ok=True)

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.dir)
                      if (m := _NAME.match(f)))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step}.pt")

    def save(self, step: int, state: dict) -> None:
        tmp = self.path(step) + f".{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, self.path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        log.info("saved checkpoint step=%d -> %s", step, self.dir)

    def restore(self, step: int | None = None,
                map_location: Any = "cpu") -> dict | None:
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self.path(step), map_location=map_location,
                          weights_only=False)
