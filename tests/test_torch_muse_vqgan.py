"""Muse over the CNN VQGAN tokenizer (``muse_vqgan``) in the port against
the JAX package on the CPU.

``cfg_exp/muse_vqgan.yaml`` cut in width: decoder dim 64, 1 layer, 2 x 32
heads, mult 2; a CLIP tower of width 32, 1 layer, 2 heads, 16 tokens; the
tokenizer VQGAN(dim 32, 64 codes), whose encoder fixes the grid at 16 x 16
= 256 tokens. JAX's weights (the generator initialised through
``loss_from_indices``, the tokenizer on 64 px images: its parameters do not
depend on the image size) are converted with ``muse_from_jax``.
Tolerances, fp32: the first decode step's logits within relative L2 1e-5;
a whole generate's final ids exactly equal given JAX's per-step Gumbel
draws (both sides' tokenizer decode intercepted in the test: 256 px images
through the CNN decoder cost the CPU more than they test, and
tests/test_torch_vqgan.py holds ``decode_indices`` to JAX); one
``MuseTrainer`` micro-step on a token grid with JAX's mask and keep draws:
the loss within relative 1e-5 and every trainable gradient within relative
L2 1e-4 of ``jax.value_and_grad`` of JAX's ``loss_from_indices``.
"""

import json
import math
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_models_torch.data.loaders import build_loader as t_build_loader
from attention_models_torch.models import muse as tmuse
from attention_models_torch.models.factory import build_model as t_build_model
from attention_models_torch.models.text_encoder import tokenize
from attention_models_torch.models.vqgan import VQGAN as TVQGAN
from attention_models_torch.training.build_trainer import build_trainer
from attention_models_torch.utils.config import load_config as t_load_config
from attention_models_torch.utils.convert import muse_from_jax
from attention_models_tpu.models.factory import build_model as j_build_model
from attention_models_tpu.models.muse import MUSE as JMuse
from attention_models_tpu.models.vqgan import VQGAN as JVQGAN
from attention_models_tpu.utils.config import load_config as j_load_config

ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG = os.path.join(ROOT, "cfg_exp", "muse_vqgan.yaml")
SMALL = {"model.dim": 64, "model.decoder.depth": 1,
         "model.decoder.n_heads": 2, "model.decoder.d_head": 32,
         "model.decoder.mult": 2, "model.encoder.width": 32,
         "model.encoder.layers": 1, "model.encoder.heads": 2,
         "model.encoder.max_length": 16, "codebook.codebook_dim": 32,
         "codebook.codebook_size": 64, "dataset.name": "synthetic",
         "dataset.params.batch_size": 2,
         "experiment.max_train_examples": 2, "training.num_epochs": 1,
         "training.gradient_accumulation_steps": 1,
         "lr_scheduler.params.warmup_steps": 0,
         "model.decoder.embeds_drop_prob": 0.5}
N_TOK, VOCAB, T = 256, 64, 4
CAPTIONS = ["a photo of a cat", "a red stop sign"]


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _cfgs(tmp_path):
    out = []
    for load in (j_load_config, t_load_config):
        cfg = load(CFG)
        for k, v in SMALL.items():
            cfg.set_path(k, v)
        out.append(cfg)
    out[1].set_path("experiment.output_dir", str(tmp_path / "out"))
    return out


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(jax model, its params, the port model with the same weights, the
    port config)"""
    jcfg, tcfg = _cfgs(tmp_path_factory.mktemp("muse_vqgan"))
    jm, _ = j_build_model(jcfg)
    ids = jnp.array(tokenize(CAPTIONS, 16))
    grid = jnp.zeros((2, N_TOK), jnp.int32)
    params = jax.jit(lambda k: jm.init(
        k, ids, grid, jax.random.key(1),
        method=JMuse.loss_from_indices))(jax.random.key(0))["params"]
    vq = jax.jit(JVQGAN(dim=32, codebook_size=VOCAB).init)(
        jax.random.key(2), jnp.zeros((1, 3, 64, 64)))["params"]
    params = {"params": {**params, "vq": vq}}
    tm = t_build_model(tcfg, "cpu")
    tm.load_state_dict(muse_from_jax(params), strict=True)
    return jm, params, tm.eval(), tcfg


def test_build_model_puts_muse_over_a_seeded_cnn_tokenizer(models):
    _, _, _, tcfg = models
    a, b = t_build_model(tcfg, "cpu"), t_build_model(tcfg, "cpu")
    assert isinstance(a, tmuse.MUSE) and isinstance(a.vq, TVQGAN)
    assert a.num_patches == N_TOK and a.codebook_size == VOCAB
    assert a.decoder.token_emb.weight.shape == (VOCAB + 1, 64)
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)  # seeded
    assert not any(p.requires_grad for p in a.vq.parameters())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_build_model(tcfg)


def test_first_step_logits_match_jax(models):
    """The first decode step's CFG forward: every position masked, the text
    and the null context in one 4-row batch."""
    jm, params, tm, _ = models
    ids = tokenize(CAPTIONS, 16)
    text_j = jm.apply(params, jnp.array(ids), method=JMuse.encode_texts)
    ctx = jnp.concatenate([text_j, jnp.zeros_like(text_j)])
    masked = jnp.full((4, N_TOK), VOCAB, jnp.int32)
    want = jm.apply(params, masked, ctx,
                    method=lambda m, x, c: m.decoder(x, c))
    with torch.no_grad():
        text = tm.encode_texts(torch.from_numpy(ids))
        got = tm.decoder(torch.from_numpy(np.asarray(masked)),
                         torch.cat([text, torch.zeros_like(text)]))
    assert got.shape == (4, N_TOK, VOCAB)
    assert _rel_l2(text.numpy(), np.asarray(text_j)) <= 1e-5
    assert _rel_l2(got.numpy(), np.asarray(want)) <= 1e-5


@pytest.mark.parametrize("approx", [False, True])
def test_generate_ids_match_jax_given_its_noise(models, monkeypatch, approx):
    jm, params, tm, _ = models
    ids = tokenize(CAPTIONS, 16)
    rng = jax.random.key(3)
    seen = []

    def grab(next_fun, args, kwargs, context):
        if context.method_name == "decode_indices":
            seen.append(np.asarray(args[0]))
            return jnp.zeros((args[0].shape[0], 3, 1, 1))
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(grab):
        jm.apply(params, jnp.array(ids), rng, timesteps=T,
                 approx_topk=approx, method=JMuse.generate)
    k = math.ceil((1 - 0.9) * VOCAB)
    noise = [_t(jax.random.gumbel(r, (2, N_TOK, VOCAB if approx else k),
                                  jnp.float32))
             for r in jax.random.split(rng, T)]
    got = []
    monkeypatch.setattr(tm.vq, "decode_indices",
                        lambda idx: got.append(idx.numpy()) or idx)
    tm.generate(torch.from_numpy(ids), timesteps=T, approx_topk=approx,
                noise=noise)
    assert got[0].shape == (2, N_TOK)
    np.testing.assert_array_equal(got[0], seen[-1])


def test_muse_trainer_token_step_matches_jax(models):
    """One fp32 micro-step of the port's MuseTrainer on a token grid (the
    ``training.cache_vq_tokens`` path; JAX's draws handed to it), its
    gradients read at ``opt.step``."""
    jm, params, _, tcfg = models
    tt = build_trainer(tcfg, t_build_model(tcfg, "cpu"),
                       t_build_loader(tcfg), "cpu")
    assert type(tt).__name__ == "MuseTrainer"
    tt.model.load_state_dict(muse_from_jax(params), strict=True)
    ids = tokenize(CAPTIONS, 16)
    grid = np.random.RandomState(1).randint(0, VOCAB, (2, N_TOK)).astype(
        np.int32)
    key = jax.random.key(1)
    mask_rng, cond_rng = jax.random.split(key)
    t_key, perm_key = jax.random.split(mask_rng)
    mask_draws = (np.array(jax.random.uniform(t_key, (2,))),
                  np.array(jax.random.uniform(perm_key, (2, N_TOK))))
    cond = np.array(jax.random.uniform(cond_rng, (2, 1, 1)))[:, 0, 0]
    assert sorted(cond < 0.5) == [False, True]  # one row trains the null

    def loss_fn(p):
        return jm.apply(p, jnp.array(ids), jnp.array(grid), key,
                        deterministic=False, method=JMuse.loss_from_indices)

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params)
    seen = []
    tt.opt.step = seen.append
    m = tt.train_step((torch.from_numpy(ids), torch.from_numpy(grid)),
                      tokens=True, mask_draws=mask_draws, cond_draws=cond)
    assert abs(float(m["loss"]) - float(loss_j)) <= 1e-5 * float(loss_j)
    want = muse_from_jax(grads_j)
    names = [k for k, p in tt.model.named_parameters()
             if not k.startswith(("vq.", "text_encoder."))]
    assert len(seen[0]) == len(names) == len(tt.trainable)
    for k, g in zip(names, seen[0]):
        assert _rel_l2(g.numpy(), want[k].numpy()) <= 1e-4, k


def test_muse_trainer_image_step_runs_the_cnn_encoder(models):
    """The image path at 256 px: the frozen CNN tokenizer's grid, one
    optimizer step, the tokenizer untouched."""
    _, _, _, tcfg = models
    tt = build_trainer(tcfg, t_build_model(tcfg, "cpu"),
                       t_build_loader(tcfg), "cpu")
    vq0 = {k: v.clone() for k, v in tt.model.vq.state_dict().items()}
    batch = next(iter(tt.batches()))
    assert batch[1].shape == (2, 3, 256, 256)
    m = tt.train_step(batch)
    assert np.isfinite(float(m["loss"])) and tt.opt.count == 1
    assert all(torch.equal(v, vq0[k])
               for k, v in tt.model.vq.state_dict().items())


def test_chip_smoke_muse_vqgan_config_restates_the_yaml():
    """chip_smoke.py builds its configs in Python (the card's machine
    promises no PyYAML): MUSE_VQGAN_YAML must equal the shipped file, and
    its training cuts are GEN_TRAIN_OVERRIDES."""
    import importlib.util

    from attention_models_torch.utils.config import Config

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    want = t_load_config(CFG)
    assert Config(mod.MUSE_VQGAN_YAML).to_dict() == want.to_dict()
    for k, v in mod.GEN_TRAIN_OVERRIDES.items():
        want.set_path(k, v)
    want.set_path("experiment.output_dir", "OUT")
    got = mod.gen_train_config(mod.MUSE_VQGAN_YAML, "OUT")
    assert got.to_dict() == want.to_dict()
