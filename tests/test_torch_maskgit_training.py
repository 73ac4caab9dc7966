"""The port's MaskGIT training slice (attention_models_torch) against the JAX
package on the CPU: the GEGLU FFN's backward, the training mask, Dropout,
the transformer's training loss and its gradients, and one whole
``MaskGitTrainer`` optimizer step; then the trainer's surroundings (token
cache, evaluation, CLI).

Sizes: the FFN at d 128, inner 256; the transformer and the trainer over
``cfg_exp/maskgit_overfit.yaml``'s tokenizer (32 px, patch 8 -> 16 tokens,
dim 32, codebook 8 dims) with dim 128, 2 x 64 heads, depth 2, mult 3
(GEGLU inner 256, the fused FFN gate) and vocab 128 (the fused head gate)
or 64 (the unfused cross-entropy), batch 2. Tolerances, fp32: the FFN
backward 2e-5 (as tests/test_ops_ffn.py); the loss 1e-5; gradients 1e-4;
the trainer's loss, parameters and Adam moments 1e-5 (atol 1e-5 of each
tensor's largest magnitude), except where Adam's first update
g / (|g| + eps) turns a gradient below 100 eps into a step of either sign:
those parameter elements are held within one step (2 lr). bf16 FFN
backward: relative L2 1e-2 against JAX's kernel in interpret mode, whose
rounding points (y, da, dgate in bf16) the plain version keeps.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_models_torch.data.loaders import build_loader as t_build_loader
from attention_models_torch.models import maskgit as tmg
from attention_models_torch.models.factory import build_model as t_build_model
from attention_models_torch.models.layers import Dropout
from attention_models_torch.ops import sampling as t_sampling
from attention_models_torch.ops.ffn import _ffn_backward_reference
from attention_models_torch.training.build_trainer import (
    build_trainer as t_build_trainer,
)
from attention_models_torch.utils.config import load_config as t_load_config
from attention_models_torch.utils import convert
from attention_models_torch.utils.convert import maskgit_from_jax
from attention_models_tpu.data import build_loader as j_build_loader
from attention_models_tpu.models.factory import build_model as j_build_model
from attention_models_tpu.models.maskgit import (
    BiDirectionalTransformer as JBiDir,
)
from attention_models_tpu.ops import sampling as j_sampling
from attention_models_tpu.ops.ffn import fused_ffn as j_fused_ffn
from attention_models_tpu.training import build_trainer as j_build_trainer
from attention_models_tpu.utils.config import load_config as j_load_config

ROOT = os.path.join(os.path.dirname(__file__), "..")
OVERFIT = os.path.join(ROOT, "cfg_exp", "maskgit_overfit.yaml")
SMALL = {"model.dim": 128, "model.n_heads": 2, "model.d_head": 64,
         "model.depth": 2, "model.mult": 3, "codebook.codebook_size": 128,
         "lr_scheduler.params.warmup_steps": 0}
LR, B1, EPS = 0.001, 0.9, 1e-8  # cfg_exp/maskgit_overfit.yaml's AdamW


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# -- the GEGLU FFN's backward ----------------------------------------------

def _ffn_grads(dtype, seed):
    rs = np.random.RandomState(seed)
    d, inner = 128, 256
    x = rs.randn(2, 32, d).astype(np.float32)
    w1 = (rs.randn(d, 2 * inner) / np.sqrt(d)).astype(np.float32)
    gamma = (1.0 + 0.1 * rs.randn(inner)).astype(np.float32)
    w2 = (rs.randn(inner, d) / np.sqrt(inner)).astype(np.float32)
    dy = rs.randn(2, 32, d).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)

    def loss(x, w1, gamma, w2):
        out = j_fused_ffn(x, w1, gamma, w2, block_rows=16, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * dy)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jx, jnp.asarray(w1), jnp.asarray(gamma), jnp.asarray(w2))
    tdt = getattr(torch, jnp.dtype(dtype).name)
    got = _ffn_backward_reference(
        _t(x).to(tdt), _t(w1).T.contiguous(), _t(gamma),
        _t(w2).T.contiguous(), _t(dy).to(tdt), 1e-5)
    # the port's weight gradients are in the torch layout
    got = [got[0].float().numpy(), got[1].T.numpy(), got[2].numpy(),
           got[3].T.numpy()]
    return got, [np.asarray(w, np.float32) for w in want]


def test_ffn_backward_reference_matches_jax_kernel_fp32():
    got, want = _ffn_grads(jnp.float32, 0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5)


def test_ffn_backward_reference_matches_jax_kernel_bf16():
    got, want = _ffn_grads(jnp.bfloat16, 1)
    for g, w in zip(got, want):
        assert _rel_l2(g, w) < 1e-2


# -- the training mask -----------------------------------------------------

@pytest.mark.parametrize("seed,b,n", [(0, 2, 16), (1, 8, 1024), (2, 3, 7)])
def test_random_mask_matches_jax_given_its_draws(seed, b, n):
    key = jax.random.key(seed)
    want = np.asarray(j_sampling.random_mask(key, b, n))
    t_key, perm_key = jax.random.split(key)
    draws = (np.asarray(jax.random.uniform(t_key, (b,))),
             np.asarray(jax.random.uniform(perm_key, (b, n))))
    got = t_sampling.random_mask(b, n, draws=[a.copy() for a in draws])
    got = got.numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum(1).min() >= 1


def test_masked_count_rounds_half_to_even():
    prob = np.array([0.125, 0.375, 0.625, 0.0, -0.2], np.float32)
    want = np.asarray(jnp.clip(jnp.round(4 * jnp.clip(jnp.asarray(prob), 0.0,
                                                      None)), 1, None))
    got = t_sampling.masked_count(torch.from_numpy(prob), 4).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [1, 2, 2, 1, 1])


def test_random_mask_from_a_generator_is_seeded():
    a = t_sampling.random_mask(4, 64, generator=torch.Generator().manual_seed(3))
    b = t_sampling.random_mask(4, 64, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.dtype == torch.bool


# -- Dropout -----------------------------------------------------------------

def test_dropout_given_keep_equals_flax_formula():
    rs = np.random.RandomState(0)
    x = rs.randn(4, 8, 16).astype(np.float32)
    keep = rs.rand(4, 8, 16) < 0.9
    want = np.asarray(jax.lax.select(jnp.asarray(keep), jnp.asarray(x) / 0.9,
                                     jnp.zeros_like(jnp.asarray(x))))
    got = Dropout(0.1)(torch.from_numpy(x), deterministic=False,
                       keep=torch.from_numpy(keep)).numpy()
    np.testing.assert_array_equal(got, want)


def test_dropout_keep_rate():
    x = torch.ones(1000, 1000)
    out = Dropout(0.1)(x, deterministic=False,
                       generator=torch.Generator().manual_seed(0))
    rate = float((out != 0).float().mean())
    assert abs(rate - 0.9) <= 0.005 * 0.9
    assert torch.allclose(out[out != 0], torch.tensor(1 / 0.9))


def test_dropout_deterministic_is_identity():
    x = torch.randn(3, 5)
    assert Dropout(0.1)(x, deterministic=True) is x
    assert Dropout(0.0)(x, deterministic=False) is x


# -- the transformer's training loss -------------------------------------

def _bt_from_jax(tree, monkeypatch):
    """A flax BiDirectionalTransformer tree -> the port module's keys
    (``maskgit_from_jax`` without a tokenizer)."""
    monkeypatch.setattr(convert, "from_jax_params", lambda t: {})
    sd = convert.maskgit_from_jax({"vq": {}, "bidirectional_transformer":
                                   tree})
    monkeypatch.undo()
    return {k.split(".", 1)[1]: v for k, v in sd.items()}


@pytest.mark.parametrize("vocab", [128, 64], ids=["fused_head", "unfused"])
def test_transformer_loss_and_gradients_match_jax(monkeypatch, vocab):
    """BiDirectionalTransformer(targets=) in fp32 with dropout inactive:
    the loss and the gradient of every parameter."""
    mg = dict(dim=128, vocab_size=vocab, num_patches=16, n_heads=2,
              d_head=64, dec_depth=2, mult=3)
    rs = np.random.RandomState(3)
    ids = rs.randint(0, vocab + 1, (2, 16)).astype(np.int32)
    tgt = rs.randint(0, vocab, (2, 16)).astype(np.int32)
    tgt[:, ::3] = -1
    jm = JBiDir(dropout=0.1, **mg)
    params = jm.init(jax.random.key(0), jnp.asarray(ids))["params"]
    tm = tmg.BiDirectionalTransformer(dropout=0.1, **mg)
    tm.load_state_dict(_bt_from_jax(params, monkeypatch), strict=True)

    def jloss(p):
        return jm.apply({"params": p}, jnp.asarray(ids), deterministic=True,
                        targets=jnp.asarray(tgt))

    want, jgrads = jax.value_and_grad(jloss)(params)
    loss = tm(torch.from_numpy(ids), deterministic=True,
              targets=torch.from_numpy(tgt))
    names = [k for k, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    jg = _bt_from_jax(jgrads, monkeypatch)
    for k, g in zip(names, grads):
        w = jg[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


# -- one whole optimizer step against the JAX trainer ----------------------

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


def _trainable(tree, vq):
    """A JAX tree of the transformer's shape -> the port's keys."""
    sd = maskgit_from_jax({"vq": vq, "bidirectional_transformer":
                           tree["bidirectional_transformer"]})
    return {k: v for k, v in sd.items()
            if k.startswith("bidirectional_transformer.")
            and not k.endswith(".beta")}


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


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(tmp_path, accum):
    """fp32, model.dropout 0, JAX's mask draws handed to the port."""
    jcfg, tcfg = _cfgs(tmp_path, **{
        "training.gradient_accumulation_steps": accum})
    jt = _jax_trainer(jcfg, tmp_path)
    tt = t_build_trainer(tcfg, t_build_model(tcfg, "cpu"),
                         t_build_loader(tcfg), "cpu")
    state = jax.tree.map(jnp.copy, jt.state)
    tt.model.load_state_dict(maskgit_from_jax(state["params"]), strict=True)
    vq0 = {k: v.clone() for k, v in tt.model.vq.state_dict().items()}
    rs = np.random.RandomState(0)
    for micro in range(accum):
        img = rs.rand(2, 3, 32, 32).astype(np.float32)
        rng = jax.random.key(7 + micro)
        mask_rng, _ = jax.random.split(rng)
        t_key, perm_key = jax.random.split(mask_rng)
        draws = (np.array(jax.random.uniform(t_key, (2,))),
                 np.array(jax.random.uniform(perm_key, (2, 16))))
        state, jm = jt._train_step(state, jnp.asarray(img), rng)
        tm = tt.train_step(torch.from_numpy(img), mask_draws=draws)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    assert tt.opt.count == 1
    vq = state["params"]["vq"]
    mu = _trainable(_find(state["opt"], "mu"), vq)
    nu = _trainable(_find(state["opt"], "nu"), vq)
    named = dict(tt.model.named_parameters())
    keys = [k for k in named if not k.startswith("vq.")]
    st = tt.opt.state
    _close({k: st[named[k]]["exp_avg"] for k in keys}, mu, "Adam mu")
    _close({k: st[named[k]]["exp_avg_sq"] for k in keys}, nu, "Adam nu")
    free = {k: np.abs(mu[k].numpy()) / (1 - B1) < 100 * EPS for k in keys}
    _close({k: named[k] for k in keys}, _trainable(state["params"], vq),
           "parameters", free=free)
    # the frozen tokenizer: untouched, outside the optimizer
    assert all(torch.equal(v, vq0[k])
               for k, v in tt.model.vq.state_dict().items())
    assert not any(p in st for p in tt.model.vq.parameters())
    decay = dict(zip(keys, tt.opt.param_groups[0]["decay"]))
    for k, on in decay.items():
        undecayed = ("input_proj.weight" in k or k.endswith("pos_enc")
                     or k.endswith(".gamma") or k.endswith(".bias"))
        assert on != undecayed, k


# -- the trainer's surroundings ------------------------------------------------

def _port_trainer(tmp_path, **extra):
    cfg = t_load_config(OVERFIT)
    for k, v in {**SMALL, "experiment.output_dir": str(tmp_path),
                 "experiment.max_train_examples": 4, **extra}.items():
        cfg.set_path(k, v)
    return t_build_trainer(cfg, t_build_model(cfg, "cpu"),
                           t_build_loader(cfg), "cpu")


def test_cached_tokens_step_equals_uncached_and_stale_cache_retokenizes(
        tmp_path):
    plain = _port_trainer(tmp_path / "a", **{"training.num_epochs": 1,
                                             "model.dropout": 0.1})
    plain.train()
    cached = _port_trainer(tmp_path / "b", **{"training.num_epochs": 1,
                                              "model.dropout": 0.1,
                                              "training.cache_vq_tokens":
                                                  True})
    ids = torch.stack([cached.model.encode_to_indices(
        torch.from_numpy(img[None]))[0]
        for img, _ in (cached.train_dl.dataset[i] for i in range(4))])
    assert np.array_equal(cached._tok_cache, ids.numpy())
    cached.train()
    assert cached.global_step == plain.global_step == 2
    for (k, a), b in zip(plain.model.state_dict().items(),
                         cached.model.state_dict().values()):
        assert torch.equal(a, b), k
    path = os.path.join(cached.checkpoint_folder, "vq_token_cache.npz")
    good = np.load(path)
    np.savez(path, cache=np.zeros_like(good["cache"]),
             digest=np.array("stale"))
    again = _port_trainer(tmp_path / "b", **{"training.cache_vq_tokens":
                                                 True})
    assert np.array_equal(again._tok_cache, good["cache"])
    assert str(np.load(path)["digest"]) == str(good["digest"])


def test_cached_tokens_refuse_random_crop(tmp_path):
    with pytest.raises(ValueError, match="random_flip/random_crop"):
        _port_trainer(tmp_path, **{"training.cache_vq_tokens": True,
                                   "dataset.preprocessing.random_crop": True})


def test_evaluate_logs_val_loss_and_writes_a_grid(tmp_path):
    tr = _port_trainer(tmp_path, **{"training.num_epochs": 1,
                                    "experiment.sample_every": 1,
                                    "training.ema_decay": 0.9,
                                    "training.eval_fid": True})
    tr.train()
    logged = [line for line in
              (tmp_path / "metrics.jsonl").read_text().splitlines()
              if "val_loss" in line]
    assert len(logged) == 1 and "val_fid_vgg" in logged[0]
    assert (tmp_path / "images" / "step_0.png").exists()
    assert set(tr.ema) == {k for k, _ in tr.model.named_parameters()
                           if not k.startswith("vq.")}
    live = dict(tr.model.named_parameters())
    assert any(not torch.equal(live[k], e) for k, e in tr.ema.items())


def test_cli_trains_two_micro_steps_on_cpu(tmp_path):
    from attention_models_torch.main import main

    tr = main([f"--config={OVERFIT}", "--device", "cpu",
               "training.num_epochs=2", f"experiment.output_dir={tmp_path}"])
    assert tr.global_step == 2 and tr.opt.count == 2
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) >= 2 and '"loss"' in lines[0]
