"""The port's ViT classifier slice (attention_models_torch) against the JAX
package on the CPU: the model's logits through ``vit_from_jax``, one whole
``VitTrainer`` optimizer step against the JAX trainer's, then the trainer's
surroundings (evaluation on a ragged tail, ImageFolder, the CLI, the
factory) and chip_smoke.py's restated configs.

Sizes: dim 128, 2 x 64 heads, depth 2, mlp 256, patch 8, 32 px (16 patches
+ the class token), 10 classes, batch 2 (the logits) or 4 (the trainer).
Tolerances, fp32: the logits 1e-5 of their largest magnitude; the step's
loss 1e-5 relative, its parameters and Adam moments 1e-5 (atol 1e-5 of each
tensor's largest magnitude), except where Adam's first update g / (|g| +
eps) turns a gradient below 100 eps into a step of either sign: those
parameter elements are held within one step (2 lr).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_models_torch.data.datasets import ImageFolder
from attention_models_torch.data.loaders import build_loader as t_build_loader
from attention_models_torch.data.transforms import Transform
from attention_models_torch.models.factory import build_model as t_build_model
from attention_models_torch.models.vit import ViT as TViT
from attention_models_torch.training.build_trainer import (
    build_trainer as t_build_trainer,
)
from attention_models_torch.utils.config import Config
from attention_models_torch.utils.config import load_config as t_load_config
from attention_models_torch.utils.convert import vit_from_jax
from attention_models_tpu.data import build_loader as j_build_loader
from attention_models_tpu.models.factory import build_model as j_build_model
from attention_models_tpu.models.vit import ViT as JViT
from attention_models_tpu.training import build_trainer as j_build_trainer
from attention_models_tpu.utils.config import load_config as j_load_config

ROOT = os.path.join(os.path.dirname(__file__), "..")
OVERFIT = os.path.join(ROOT, "cfg_exp", "vit_overfit.yaml")
VIT = dict(dim=128, image_size=32, patch_size=8, n_heads=2, d_head=64,
           depth=2, mlp_dim=256, num_classes=10)
SMALL = {"model.transformer.dim": 128, "model.transformer.n_heads": 2,
         "model.transformer.d_head": 64, "model.transformer.depth": 2,
         "model.transformer.mlp_dim": 256, "model.transformer.dropout": 0.0,
         "lr_scheduler.params.warmup_steps": 0}
LR, B1, EPS = 0.001, 0.9, 1e-8  # cfg_exp/vit_overfit.yaml's AdamW


def _close(got, want, what, free=None):
    assert set(got) == set(want), what
    for k, w in want.items():
        w = w.double().numpy()
        g = got[k].detach().double().numpy()
        if free is not None:
            assert np.all(np.abs(g - w)[free[k]] <= 2 * LR), f"{what}: {k}"
            g = np.where(free[k], w, g)
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{what}: {k}")


def test_vit_logits_match_jax():
    imgs = np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32)
    jm = JViT(**VIT)
    params = jm.init(jax.random.key(0), jnp.asarray(imgs))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(imgs)))
    tm = TViT(**VIT)
    tm.load_state_dict(vit_from_jax(params), strict=True)
    got = tm(torch.from_numpy(imgs)).detach().numpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # bf16 compute over the same fp32 parameters: a bf16-scale gap
    tb = TViT(**VIT, dtype=torch.bfloat16)
    tb.load_state_dict(vit_from_jax(params), strict=True)
    with torch.no_grad():
        out = tb(torch.from_numpy(imgs))
    assert out.dtype == torch.bfloat16
    err = np.linalg.norm(out.float().numpy() - want) / np.linalg.norm(want)
    assert err < 3e-2


def _cfgs(tmp_path, **extra):
    cfgs = []
    for load in (j_load_config, t_load_config):
        cfg = load(OVERFIT)
        for k, v in {**SMALL, **extra}.items():
            cfg.set_path(k, v)
        cfgs.append(cfg)
    cfgs[1].set_path("experiment.output_dir", str(tmp_path / "torch_out"))
    return cfgs


def _jax_trainer(cfg, tmp_path):
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        model, patches = j_build_model(cfg)
        return j_build_trainer(cfg, model, j_build_loader(cfg),
                               pretrained_patches=patches)
    finally:
        os.chdir(cwd)


def _find(obj, attr):
    """The first node of an optax state with ``attr`` (e.g. ``mu``)."""
    if hasattr(obj, attr):
        return getattr(obj, attr)
    if isinstance(obj, (tuple, list)):
        for x in obj:
            found = _find(x, attr)
            if found is not None:
                return found
    for name in getattr(obj, "_fields", ()):
        found = _find(getattr(obj, name), attr)
        if found is not None:
            return found
    return None


def test_train_step_matches_jax(tmp_path):
    """fp32, dropout 0, one optimizer step: loss, accuracy, Adam moments
    and every parameter."""
    jcfg, tcfg = _cfgs(tmp_path)
    jt = _jax_trainer(jcfg, tmp_path)
    tt = t_build_trainer(tcfg, t_build_model(tcfg, "cpu"),
                         t_build_loader(tcfg), "cpu")
    state = jax.tree.map(jnp.copy, jt.state)
    tt.model.load_state_dict(vit_from_jax(state["params"]), strict=True)
    rs = np.random.RandomState(0)
    img = rs.rand(4, 3, 32, 32).astype(np.float32)
    tgt = np.array([1, 7, 3, 7], np.int32)
    state, jm = jt._train_step(state, jnp.asarray(img), jnp.asarray(tgt),
                               jax.random.key(1))
    tm = tt.train_step(torch.from_numpy(img), tt.labels(tgt))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert float(tm["acc"]) == float(jm["acc"])
    assert tt.opt.count == 1 and tt.schedule(0) == LR
    named = dict(tt.model.named_parameters())
    st = tt.opt.state

    def port_keys(sd):
        return {k: v for k, v in sd.items() if k in named}

    mu = port_keys(vit_from_jax(_find(state["opt"], "mu")))
    nu = port_keys(vit_from_jax(_find(state["opt"], "nu")))
    _close({k: st[p]["exp_avg"] for k, p in named.items()}, mu, "Adam mu")
    _close({k: st[p]["exp_avg_sq"] for k, p in named.items()}, nu, "Adam nu")
    free = {k: np.abs(mu[k].numpy()) / (1 - B1) < 100 * EPS for k in named}
    _close(named, port_keys(vit_from_jax(state["params"])), "parameters",
           free=free)


def _port_trainer(tmp_path, **extra):
    cfg = t_load_config(OVERFIT)
    for k, v in {**SMALL, "experiment.output_dir": str(tmp_path),
                 **extra}.items():
        cfg.set_path(k, v)
    return t_build_trainer(cfg, t_build_model(cfg, "cpu"),
                           t_build_loader(cfg), "cpu")


def test_evaluate_keeps_only_the_real_rows_of_a_ragged_tail(tmp_path):
    """8 examples: 2 validation images in one batch padded to 4; the
    accuracy is over those 2, through the EMA weights."""
    tr = _port_trainer(tmp_path, **{"training.ema_decay": 0.5})
    assert len(tr.val_dl.dataset) == 2 and tr.batch_size == 4
    img, tgt = next(iter(tr.val_dl))
    with torch.no_grad(), tr.eval_weights(tr.model):
        pred = tr.model(torch.from_numpy(img)).argmax(-1).numpy()
    want = float(np.mean(pred == tgt))
    assert tr.evaluate() == want
    logged = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert '"val_acc"' in logged[-1]


def test_imagefolder_reads_generated_pngs(tmp_path):
    from PIL import Image

    rs = np.random.RandomState(0)
    for cls, n in (("cat", 2), ("dog", 3)):
        os.makedirs(tmp_path / cls)
        for i in range(n):
            arr = rs.randint(0, 256, (40, 48, 3), dtype=np.uint8)
            Image.fromarray(arr).save(tmp_path / cls / f"{i}.png")
    (tmp_path / "dog" / "notes.txt").write_text("not an image")
    cfg = t_load_config(OVERFIT)
    ds = ImageFolder(str(tmp_path), Transform(cfg, is_train=False))
    assert ds.class_to_idx == {"cat": 0, "dog": 1} and len(ds) == 5
    img, label = ds[3]
    assert img.shape == (3, 32, 32) and img.dtype == np.float32 and label == 1
    assert 0.0 <= img.min() and img.max() <= 1.0
    cfg.set_path("dataset.name", "imagenet")
    cfg.set_path("dataset.params.train_path", str(tmp_path))
    with pytest.raises(ValueError, match="train_test_split"):
        t_build_loader(cfg)
    cfg.set_path("dataset.params.train_test_split", 0.6)
    train_dl, val_dl = t_build_loader(cfg)
    assert len(train_dl.dataset) == 3 and len(val_dl.dataset) == 2
    imgs, labels = next(iter(val_dl))
    assert imgs.shape == (2, 3, 32, 32) and labels.dtype == np.int32


def test_cli_trains_and_evaluates_on_cpu(tmp_path):
    from attention_models_torch.main import main

    tr = main([f"--config={OVERFIT}", "--device", "cpu",
               "training.num_epochs=2", "experiment.eval_every=3",
               f"experiment.output_dir={tmp_path}"])
    assert tr.global_step == 4 and tr.opt.count == 4
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert '"loss"' in lines[0] and '"acc"' in lines[0]
    assert any('"val_acc"' in line for line in lines)


def test_build_model_vit_is_seeded_and_vit_moe_waits_for_its_slice(tmp_path):
    cfg = t_load_config(OVERFIT)
    a = t_build_model(cfg, "cpu").state_dict()
    b = t_build_model(cfg, "cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert abs(float(a["pos_enc"].std()) - 1.0) < 0.1
    cfg.set_path("training.mixed_precision", "bf16")
    m = t_build_model(cfg, "cpu")
    assert m.dtype == torch.bfloat16 and m.final_fc.weight.dtype == torch.float32
    # its slice is ported: the factory and the trainer take vit_moe (its
    # own widths from cfg/vit_moe.yaml, tests/test_torch_vit_moe.py)
    cfg.set_path("model.name", "vit_moe")
    cfg.set_path("experiment.output_dir", str(tmp_path))
    for k, v in (("n_experts", 4), ("sel_experts", 2),
                 ("capacity_factor", 2.0)):
        cfg.set_path(f"model.transformer.{k}", v)
    moe = t_build_model(cfg, "cpu")
    assert type(moe).__name__ == "ViTMoE" and moe.dtype == torch.bfloat16
    assert type(t_build_trainer(cfg, moe, t_build_loader(cfg), "cpu")
                ).__name__ == "VitTrainer"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_vit_config_restates_vit_yaml():
    """chip_smoke.py builds its configs in Python (the card's machine
    promises no PyYAML): cfg/vit.yaml and cfg_exp/vitvqgan_overfit.yaml."""
    mod = _chip_smoke()
    want = t_load_config(os.path.join(ROOT, "cfg", "vit.yaml"))
    assert Config(mod.VIT_YAML).to_dict() == want.to_dict()
    for k, v in mod.VIT_OVERRIDES.items():
        want.set_path(k, v)
    want.set_path("model.transformer.dropout", 0.0)
    want.set_path("experiment.output_dir", "OUT")
    assert mod.vit_config(0.0, "OUT").to_dict() == want.to_dict()
    overfit = t_load_config(os.path.join(ROOT, "cfg_exp",
                                         "vitvqgan_overfit.yaml"))
    assert Config(mod.VQGAN_OVERFIT_YAML).to_dict() == overfit.to_dict()
