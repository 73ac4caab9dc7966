"""Training CLI of the port:

    python -m attention_models_torch.main --config=cfg/vitvqgan.yaml \
        [dotted.key=value ...] [--device cuda|cpu]

(``cfg/maskgit.yaml`` trains MaskGIT over the frozen tokenizer,
``cfg/vit.yaml`` the ViT classifier, ``cfg/vit_moe.yaml`` the ViT-MoE;
``cfg_exp/*_overfit.yaml`` are their small synthetic runs.)

Counterpart of the repository's ``main.py``: config -> model -> loaders ->
trainer -> ``train()``. ``--device`` defaults to the card and raises without
CUDA; ``--device cpu`` runs the plain PyTorch path on the CPU.
"""

from __future__ import annotations

import logging
import sys

from attention_models_torch.data.loaders import build_loader
from attention_models_torch.models.factory import build_model
from attention_models_torch.ops.dispatch import resolve_device
from attention_models_torch.training.build_trainer import build_trainer
from attention_models_torch.utils.config import config_from_cli

LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
          "warning": logging.WARNING, "error": logging.ERROR}


def _split_device(argv: list[str]) -> tuple[str | None, list[str]]:
    """``--device X`` / ``--device=X`` out of argv; the rest is the config."""
    device, rest, it = None, [], iter(argv)
    for arg in it:
        if arg == "--device":
            device = next(it, None)
            if device is None:
                raise SystemExit("--device needs a value (cuda or cpu)")
        elif arg.startswith("--device="):
            device = arg.partition("=")[2]
        else:
            rest.append(arg)
    return device, rest


def main(argv: list[str]):
    device, argv = _split_device(argv)
    dev = resolve_device(device)
    cfg = config_from_cli(argv)
    level = str(cfg.experiment.get("log_level", "info")).lower()
    if level not in LEVELS:
        raise SystemExit(f"unknown experiment.log_level {level!r}; valid: "
                         f"{sorted(LEVELS)}")
    logging.basicConfig(level=LEVELS[level],
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    trainer = build_trainer(cfg, build_model(cfg, dev), build_loader(cfg),
                            dev)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
