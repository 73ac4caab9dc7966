"""The port's ViTVQGAN GAN training step (attention_models_torch.training)
against the JAX trainer's, and the trainer's surroundings.

The whole slice: ``VQGANTrainer`` of each package is built from
``cfg_exp/vitvqgan_overfit.yaml`` at the sizes of
tests/test_torch_vitvqgan.py (32 px, batch 2, dim 128, depth 2, 2 x 64
heads, codebook 64 x 16), warmup 0 so the first step moves the weights at
the full rate. The JAX state (generator, discriminator with its BatchNorm
statistics, LPIPS tower) is converted into the port, both take the same
batches and the same GP ``eta``, in fp32 on the CPU, with gradient
accumulation 1 and 2. Compared at rtol 1e-4: every logged loss, the
post-step G and D parameters, the BatchNorm statistics and Adam's first
moments (JAX ``mu`` against torch ``exp_avg``, which expose the clipped
gradients). atol is 1e-5 of each tensor's largest magnitude, for elements
that round to near zero. Adam's first update is g / (|g| + eps), which turns
the rounding of a gradient element below 100 eps into a change of up to the
whole step: those parameter elements are held within one step (2 lr).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_models_torch.data.loaders import build_loader as t_build_loader
from attention_models_torch.models.factory import build_model as t_build_model
from attention_models_torch.training.build_trainer import (
    build_trainer as t_build_trainer,
)
from attention_models_torch.utils.config import Config
from attention_models_torch.utils.config import load_config as t_load_config
from attention_models_torch.utils.convert import (
    discriminator_from_jax,
    from_jax_params,
    lpips_from_jax,
)
from attention_models_tpu.data import build_loader as j_build_loader
from attention_models_tpu.models.factory import build_model as j_build_model
from attention_models_tpu.training import build_trainer as j_build_trainer
from attention_models_tpu.utils.config import load_config as j_load_config

ROOT = os.path.join(os.path.dirname(__file__), "..")
OVERFIT = os.path.join(ROOT, "cfg_exp", "vitvqgan_overfit.yaml")
SMALL = {"model.transformer.dim": 128, "model.transformer.n_heads": 2,
         "model.transformer.d_head": 64, "model.transformer.depth": 2,
         "model.transformer.mlp_dim": 256, "codebook.codebook_size": 64,
         "codebook.codebook_dim": 16, "lr_scheduler.params.warmup_steps": 0}


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


LR, B1, EPS = 0.001, 0.9, 1e-8  # cfg_exp/vitvqgan_overfit.yaml's Adam


def _close(got: dict, want: dict, what: str, rtol=1e-4, free=None):
    """rtol, with atol 1e-5 of each tensor's largest magnitude; where
    ``free[k]`` is True the elements need only agree within one step."""
    assert set(got) == set(want), what
    for k in want:
        w = np.asarray(want[k], np.float64)
        g = got[k].detach().double().numpy()
        atol = 1e-5 * max(float(np.abs(w).max()), 1e-30)
        if free is not None and k in free:
            assert np.all(np.abs(g - w)[free[k]] <= 2 * LR), f"{what}: {k}"
            g = np.where(free[k], w, g)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


def _load_jax_state(tt, jt, state):
    tt.model.load_state_dict(from_jax_params(state["g_params"]), strict=True)
    tt.discr.load_state_dict(
        discriminator_from_jax(state["d_params"], state["d_stats"]),
        strict=True)
    tt.lpips.load_state_dict(lpips_from_jax(jt.lpips_params), strict=True)


def _compare_step(tt, state, jm, tm):
    """Every logged loss and the BatchNorm statistics."""
    _close({k: tm[k] for k in jm}, {k: float(v) for k, v in jm.items()},
           "losses")
    want = discriminator_from_jax(state["d_params"], state["d_stats"])
    _close({k: v for k, v in tt.discr.state_dict().items()
            if k.endswith((".mean", ".var"))},
           {k: v for k, v in want.items() if k.endswith((".mean", ".var"))},
           "D batch stats")


def _compare_update(tt, state):
    """After the one optimizer step: Adam's first moments, then the G and D
    parameters. Adam's first update is g / (|g| + eps), so where the
    gradient |g| = |mu| / (1 - b1) is below 100 eps the rounding of g moves
    the update by up to a whole step: there the parameters need only agree
    within one step (2 lr); everywhere else at rtol 1e-4."""
    for opt, module, tree, params, conv in (
            (tt.g_opt, tt.model, state["g_opt"], state["g_params"],
             from_jax_params),
            (tt.d_opt, tt.discr, state["d_opt"], state["d_params"],
             lambda m: discriminator_from_jax(m, state["d_stats"]))):
        mu = conv(_find(tree, "mu"))
        got = {k: opt.state[p]["exp_avg"]
               for k, p in module.named_parameters()}
        _close(got, {k: mu[k] for k in got}, "Adam first moments")
        free = {k: np.abs(np.asarray(mu[k])) / (1 - B1) < 100 * EPS
                for k in got}
        new = conv(params)
        _close(dict(module.named_parameters()), {k: new[k] for k in got},
               "parameters", free=free)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(tmp_path, accum):
    jcfg, tcfg = _cfgs(tmp_path, **{
        "training.gradient_accumulation_steps": accum})
    jt = _jax_trainer(jcfg, tmp_path)
    tt = t_build_trainer(tcfg, t_build_model(tcfg), t_build_loader(tcfg),
                         "cpu")
    state = jax.tree.map(jnp.copy, jt.state)
    _load_jax_state(tt, jt, state)

    g0 = {k: v.clone() for k, v in tt.model.state_dict().items()}
    rs = np.random.RandomState(0)
    for micro in range(accum):
        img = rs.rand(2, 3, 32, 32).astype(np.float32)
        rng = jax.random.key(7 + micro)
        eta = np.array(jax.random.uniform(rng, (2, 1, 1, 1), jnp.float32))
        state, jm = jt._train_step(state, jnp.asarray(img), rng)
        tm = tt.train_step(torch.from_numpy(img), eta=torch.from_numpy(eta))
        _compare_step(tt, state, jm, tm)
        if micro < accum - 1:  # MultiSteps: no update between
            assert all(torch.equal(g0[k], v)
                       for k, v in tt.model.state_dict().items())
    assert tt.g_opt.count == tt.d_opt.count == 1
    _compare_update(tt, state)


@pytest.mark.parametrize("name", ["timm_cosine", "cosine_with_warmup",
                                  "constant_with_warmup"])
def test_schedules_match_jax(name):
    from attention_models_torch.training import schedules as t_sched
    from attention_models_tpu.training import schedules as j_sched

    args = {"timm_cosine": (3e-4, 1000, 100),
            "cosine_with_warmup": (3e-4, 100, 1000),
            "constant_with_warmup": (3e-4, 100)}[name]
    t_fn, j_fn = getattr(t_sched, name)(*args), getattr(j_sched, name)(*args)
    # JAX evaluates the schedules in fp32: rtol 1e-5, atol 1e-5 of the rate
    for step in (0, 1, 50, 99, 100, 101, 550, 999, 1000, 5000):
        np.testing.assert_allclose(t_fn(step), float(j_fn(step)), rtol=1e-5,
                                   atol=1e-5 * args[0],
                                   err_msg=f"{name} step {step}")


def _maskgit_params(rs):
    """A small MaskGIT of each package with the same random weights: the JAX
    tree (shapes by tracing only) and the port module."""
    from attention_models_torch.models.maskgit import MaskGitTransformer
    from attention_models_torch.utils.convert import maskgit_from_jax
    from attention_models_tpu.models.maskgit import (
        MaskGitTransformer as JMaskGit,
    )

    vit = dict(dim=32, img_size=32, patch_size=8, n_heads=2, d_head=16,
               depth=1, mlp_dim=64, dropout=0.0)
    kw = dict(vq_config=dict(vit_params=vit, codebook_params=dict(
        codebook_size=64, codebook_dim=8)), dim=64, vocab_size=64,
        n_heads=2, d_head=32, dec_depth=1, mult=2)
    jm = JMaskGit(**kw)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 3, 32, 32)), jax.random.key(1),
        method=JMaskGit.init_all))["params"]
    params = jax.tree.map(lambda a: _np32(rs, *a.shape) * 0.1, shapes)
    tm = MaskGitTransformer(**kw)
    tm.load_state_dict(maskgit_from_jax(params), strict=True)
    return params, tm


def _mask_as_port(mask, params):
    """A JAX tree of booleans -> one bool per port parameter key."""
    from attention_models_torch.utils.convert import maskgit_from_jax

    full = jax.tree.map(lambda m, p: np.full(p.shape, m, np.float32), mask,
                        params)
    return {k: bool(v.all()) for k, v in maskgit_from_jax(full).items()
            if not k.endswith(".beta")}


@pytest.mark.parametrize("name,wd,maskgit", [
    pytest.param("adam", 0.0, False, id="adam-0.0"),
    pytest.param("adam", 0.01, False, id="adam-0.01"),
    pytest.param("adamw", 0.01, False, id="adamw-0.01"),
    pytest.param("adamw", 0.01, True, id="adamw-0.01-maskgit"),
    pytest.param("adam", 0.01, True, id="adam-0.01-maskgit")])
def test_optimizer_matches_optax_multisteps(name, wd, maskgit):
    """OptaxAdam against the JAX package's build_optimizer (clip -> adam /
    adamw inside MultiSteps(k=2)) over 4 micro-steps of the same gradients,
    one clipped and one not per optimizer step: parameters and first
    moments at rtol 1e-5. The ``maskgit`` cases build both over a small
    MaskGIT with the generator trainers' frozen ``vq`` and no-decay
    grouping: ``decay_mask`` and ``frozen_mask`` equal JAX's on the same
    model, the frozen tokenizer gets no state and does not move."""
    import optax

    from attention_models_torch.training import optim as t_optim
    from attention_models_torch.training.schedules import timm_cosine as t_tc
    from attention_models_tpu.training import optim as j_optim
    from attention_models_tpu.training.schedules import timm_cosine as j_tc

    cfgs = []
    for load in (j_load_config, t_load_config):
        cfg = load(OVERFIT)
        cfg.set_path("optimizer.name", name)
        cfg.set_path("optimizer.params.weight_decay", wd)
        cfg.set_path("training.gradient_accumulation_steps", 2)
        cfgs.append(cfg)
    rs = np.random.RandomState(4)
    if maskgit:
        params, tm = _maskgit_params(rs)
        frozen = ("vq",)
        assert t_optim.decay_mask(tm) == _mask_as_port(
            j_optim.decay_mask(params), params)
        assert t_optim.frozen_mask(tm, frozen) == _mask_as_port(
            j_optim.frozen_mask(params, frozen), params)
        named = dict(tm.named_parameters())
        keys = [k for k in named if not k.startswith("vq.")]
        t_params = [named[k] for k in keys]
        opt = t_optim.build_optimizer(cfgs[1], t_tc(1e-3, 10, 2), tm,
                                      frozen_subtrees=frozen,
                                      no_decay_grouping=True)
        assert opt.param_groups[0]["params"] == t_params
    else:
        params = {"a": _np32(rs, 16, 8), "b": _np32(rs, 8)}
        frozen = ()
        keys = ["a", "b"]
        t_params = [torch.from_numpy(params[k].copy()) for k in keys]
        opt = t_optim.build_optimizer(cfgs[1], t_tc(1e-3, 10, 2), t_params)
    scales = (0.01, 3.0, 0.02, 0.01) if not maskgit else (1e-3, 0.3, 2e-3,
                                                          1e-3)
    grads = [jax.tree.map(lambda a: _np32(rs, *a.shape) * s, params)
             for s in scales]  # micro-step 1 gets clipped
    j_params = jax.tree.map(jnp.asarray, params)
    tx = j_optim.build_optimizer(cfgs[0], j_tc(1e-3, 10, 2), j_params,
                                 frozen_subtrees=frozen,
                                 no_decay_grouping=maskgit)
    j_state = tx.init(j_params)
    for g in grads:
        upd, j_state = tx.update(jax.tree.map(jnp.asarray, g), j_state,
                                 j_params)
        j_params = optax.apply_updates(j_params, upd)
        tg = (_mask_as_port_values(g) if maskgit else
              {k: torch.from_numpy(g[k]) for k in keys})
        opt.step([tg[k] for k in keys])
    mu = _find(j_state, "mu")
    if maskgit:
        want_p = _mask_as_port_values(j_params)
        want_mu = _mask_as_port_values({"vq": params["vq"],
                                        "bidirectional_transformer":
                                            mu["bidirectional_transformer"]})
        vq = _mask_as_port_values(params)
        for k, p in tm.named_parameters():
            if k.startswith("vq."):
                assert torch.equal(p.detach(), vq[k]) and p not in opt.state
    else:
        want_p = {k: torch.from_numpy(np.array(j_params[k])) for k in keys}
        want_mu = {k: torch.from_numpy(np.array(mu[k])) for k in keys}
    # the maskgit cases: atol for elements that round to near zero
    atol_p, atol_mu = (1e-7, 1e-9) if maskgit else (0, 0)
    for k, p in zip(keys, t_params):
        np.testing.assert_allclose(p.detach().numpy(), want_p[k].numpy(),
                                   rtol=1e-5, atol=atol_p, err_msg=k)
        np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(),
                                   want_mu[k].numpy(), rtol=1e-5,
                                   atol=atol_mu, err_msg=k)
    assert opt.count == 2


def _mask_as_port_values(tree):
    """A JAX MaskGIT tree of arrays -> the port's keys."""
    from attention_models_torch.utils.convert import maskgit_from_jax

    return maskgit_from_jax(jax.tree.map(np.asarray, tree))


def _np32(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def test_checkpoint_resume_equals_uninterrupted(tmp_path):
    """A run of 4 micro-steps (2 epochs of 2 batches, accumulation 2, EMA)
    checkpoints after step 3: mid-epoch and mid-accumulation. A fresh
    trainer resumed from it ends with the same parameters, BatchNorm
    statistics, optimizer state and EMA as the run that never stopped."""
    def trainer(**extra):
        cfg = t_load_config(OVERFIT)
        for k, v in {**SMALL, "experiment.output_dir": str(tmp_path),
                     "experiment.eval_every": 0, "experiment.sample_every": 0,
                     "experiment.max_train_examples": 4,
                     "experiment.save_every": 2, "training.num_epochs": 2,
                     "training.gradient_accumulation_steps": 2,
                     "training.ema_decay": 0.9, **extra}.items():
            cfg.set_path(k, v)
        return t_build_trainer(cfg, t_build_model(cfg), t_build_loader(cfg),
                               "cpu")

    full = trainer()
    full.train()
    assert full.global_step == 4 and full.ckpt.latest_step() == 3
    resumed = trainer(**{"experiment.resume_path_from_checkpoint":
                         full.ckpt.dir})
    assert resumed.global_step == 3
    assert resumed.g_opt.param_groups[0]["mini_step"] == 1
    resumed.train()
    assert resumed.global_step == 4
    for a, b in ((full.model, resumed.model), (full.discr, resumed.discr)):
        sa, sb = a.state_dict(), b.state_dict()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    for k in full.ema:
        assert torch.equal(full.ema[k], resumed.ema[k]), k
    for opt_a, opt_b in ((full.g_opt, resumed.g_opt),
                         (full.d_opt, resumed.d_opt)):
        pa, pb = opt_a.param_groups[0], opt_b.param_groups[0]
        assert (pa["count"], pa["mini_step"]) == (pb["count"], pb["mini_step"])
        for p, q in zip(pa["params"], pb["params"]):
            for key in ("exp_avg", "exp_avg_sq", "acc_grad"):
                assert torch.equal(opt_a.state[p][key], opt_b.state[q][key])


def test_cli_runs_two_micro_steps_on_cpu(tmp_path):
    from attention_models_torch.main import main

    tr = main([f"--config={OVERFIT}", "--device", "cpu",
               "training.num_epochs=2",
               f"experiment.output_dir={tmp_path}"])
    assert tr.global_step == 2
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) >= 2 and '"d_loss"' in lines[0]


def test_evaluate_logs_psnr_fid_and_grid(tmp_path):
    """The sample cadence runs evaluate(): PSNR and the VGG FID through the
    EMA weights, a reconstruction grid on disk, the live weights back."""
    pytest.importorskip("PIL")
    from attention_models_torch.main import main

    tr = main([f"--config={OVERFIT}", "--device", "cpu",
               "training.num_epochs=2", "experiment.sample_every=1",
               "training.ema_decay=0.9",
               f"experiment.output_dir={tmp_path}"])
    logged = [line for line in
              (tmp_path / "metrics.jsonl").read_text().splitlines()
              if "val_psnr_db" in line]
    assert len(logged) == 1 and "val_fid_vgg" in logged[0]
    assert (tmp_path / "images" / "step_0.png").exists()
    live = dict(tr.model.named_parameters())
    assert any(not torch.equal(live[k], e) for k, e in tr.ema.items())


def test_config_matches_jax_loader(tmp_path):
    t = t_load_config(OVERFIT)
    j = j_load_config(OVERFIT)
    assert t.to_dict() == j.to_dict()
    assert t.lr_scheduler.params.learning_rate == 0.001
    from attention_models_torch.utils.config import config_from_cli
    from attention_models_tpu.utils.config import (
        config_from_cli as j_config_from_cli,
    )

    argv = [f"--config={OVERFIT}", "training.seed=3", "a.b=[1,2]", "x=null"]
    assert config_from_cli(argv).to_dict() == j_config_from_cli(argv).to_dict()


@pytest.mark.parametrize("which", ["synthetic", "coco"])
def test_loaders_match_jax(which):
    pytest.importorskip("PIL")
    t, j = t_load_config(OVERFIT), j_load_config(OVERFIT)
    if which == "coco":
        for cfg in (t, j):
            cfg.set_path("dataset.name", "coco")
            cfg.set_path("dataset.params.train_path",
                         os.path.join(ROOT, "data", "coco_mini"))
            cfg.set_path("dataset.params.val_path",
                         os.path.join(ROOT, "data", "coco_mini"))
            cfg.set_path("experiment.max_train_examples", 6)
            cfg.set_path("dataset.preprocessing.random_flip", True)
            cfg.set_path("dataset.preprocessing.random_crop", True)
            cfg.set_path("dataset.preprocessing.scale", 0.8)
    (tt, tv), (jtr, jv) = t_build_loader(t), j_build_loader(j)
    assert len(tt) == len(jtr) and len(tv) == len(jv)
    for epoch in (0, 1):
        tt.set_epoch(epoch)
        jtr.set_epoch(epoch)
        for (ti, tc), (ji, jc) in zip(tt, jtr):
            np.testing.assert_array_equal(ti, ji)
            assert list(tc) == list(jc)
    for (ti, _), (ji, _) in zip(tv, jv):
        np.testing.assert_array_equal(ti, ji)


def test_chip_smoke_training_config_restates_vitvqgan_yaml():
    """chip_smoke.py builds its training config in Python (the card's
    machine promises no PyYAML); it must equal cfg/vitvqgan.yaml with the
    same overrides."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = mod.training_config("OUT")
    want = t_load_config(os.path.join(ROOT, "cfg", "vitvqgan.yaml"))
    for k, v in mod.TRAIN_OVERRIDES.items():
        want.set_path(k, v)
    want.set_path("experiment.output_dir", "OUT")
    assert isinstance(got, Config)
    assert got.to_dict() == want.to_dict()
