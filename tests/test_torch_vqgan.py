"""The port's CNN VQGAN tokenizer (attention_models_torch.models.vqgan)
against the JAX package's on the CPU.

Each block (GroupNorm, the residual block with and without its 1x1
``channel_up``, up- and down-sampling, the NonLocal block) against its flax
module at 64 channels, 8 x 8, fp32: relative L2 <= 1e-5. The whole
``VQGAN(dim=32, codebook_size=64)`` at 64 px (the size of
tests/test_parity_vision.py), initialised in JAX and converted with
``vqgan_from_jax`` (a strict ``load_state_dict``), fp32: indices exactly
equal, reconstruction, loss and ``decode_indices`` within relative 1e-5.
The bf16 model (compute dtype over the same fp32 weights) against JAX's
fp32: the encoder output z and the decoder on identical indices within
relative L2 3e-2 (bf16 rounding through some 30 layers); its whole
reconstruction is not gated, since one index flipped at a near-tie moves
it by O(1), as it does JAX's own bf16 model. Kernel 4's plain version at
width 256 (the tokenizer's code width) against ``_nearest_codes_xla`` on
fp32 and on bf16 operands: every index equal. Then the factory, the
services, the CLI and the GAN trainer on a ``vqgan`` config.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_models_torch.models import vqgan as tv
from attention_models_torch.ops.codebook import _nearest_codes_reference
from attention_models_torch.serving import vq_encode_service, vq_recon_service
from attention_models_torch.utils import convert
from attention_models_tpu.models import vqgan as jv
from attention_models_tpu.ops.codebook import _nearest_codes_xla, l2_normalize

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


BLOCKS = {
    "norm": (lambda: jv.GroupNorm(64), dict(channels=64)),
    "res": (lambda: jv.ResidualBlock(64, 64),
            dict(in_channels=64, out_channels=64)),
    "res_channel_up": (lambda: jv.ResidualBlock(64, 128),
                       dict(in_channels=64, out_channels=128)),
    "up": (lambda: jv.UpSampleBlock(64), dict(channels=64)),
    "down": (lambda: jv.DownSampleBlock(64), dict(channels=64)),
    "attn": (lambda: jv.NonLocalBlock(64), dict(channels=64)),
}


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_matches_flax(kind):
    """One block as a one-layer planned stack (its keys ``model.0.*``)."""
    make, kw = BLOCKS[kind]
    x = np.random.RandomState(3).randn(2, 8, 8, 64).astype(np.float32)
    jm = make()
    params = jm.init(jax.random.key(1), jnp.array(x))["params"]
    # non-trivial GroupNorm affines and conv biases
    leaves, tree = jax.tree_util.tree_flatten(params)
    rs = np.random.RandomState(2)
    params = jax.tree_util.tree_unflatten(tree, [
        v + 0.1 * rs.randn(*v.shape).astype(np.float32) for v in leaves])
    want = np.asarray(jm.apply({"params": params}, jnp.array(x)))
    plan_kind = kind.replace("_channel_up", "")
    tm = tv.PlannedStack([(plan_kind, kw)])
    sd = {}
    convert._planned_stack({"m0": params}, "model", [(plan_kind, kw)], sd)
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert _rel_l2(got.numpy(), want) <= 1e-5


def test_group_norm_takes_flax_statistics_in_bf16():
    """bf16 input: fp32 statistics as flax takes them, one final cast; the
    port's output equals flax's bf16 GroupNorm within one bf16 ulp."""
    x = (np.random.RandomState(4).randn(2, 4, 4, 64) * 3 + 2).astype(
        np.float32)
    jm = jv.GroupNorm(64, dtype=jnp.bfloat16)
    xb = jnp.array(x, jnp.bfloat16)
    params = jm.init(jax.random.key(0), xb)
    want = np.asarray(jm.apply(params, xb).astype(jnp.float32))
    tm = tv.GroupNorm(64)
    with torch.no_grad():
        got = tm(_t(x).to(torch.bfloat16).permute(0, 3, 1, 2))
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)) <= 2 ** -7


@pytest.fixture(scope="module")
def pair():
    imgs = np.random.RandomState(0).rand(2, 3, 64, 64).astype(np.float32)
    jm = jv.VQGAN(dim=32, codebook_size=64)
    params = jax.jit(jm.init)(jax.random.key(0), jnp.array(imgs))
    tm = tv.VQGAN(32, 64)
    tm.load_state_dict(convert.vqgan_from_jax(params), strict=True)
    return jm, params, tm.eval(), imgs


def test_vqgan_from_jax_covers_every_key(pair):
    _, params, tm, _ = pair
    sd = convert.vqgan_from_jax(params)
    assert set(sd) == set(tm.state_dict())
    assert all(sd[k].shape == v.shape for k, v in tm.state_dict().items())
    assert "encoder.model.2.block.0.gn.weight" in sd  # reference keys
    assert "decoder.model.2.gn.gn.weight" in sd


def test_forward_encode_decode_match_jax(pair):
    jm, params, tm, imgs = pair
    x = jnp.array(imgs)
    rec_j, loss_j = jm.apply(params, x)
    idx_j = np.asarray(jm.apply(params, x, method=jv.VQGAN.encode_imgs))
    dec_j = jm.apply(params, jnp.array(idx_j),
                     method=jv.VQGAN.decode_indices)
    with torch.no_grad():
        rec, loss = tm(_t(imgs))
        idx = tm.encode_imgs(_t(imgs))
        dec = tm.decode_indices(torch.from_numpy(idx_j.copy()))
    assert idx.dtype == torch.int32 and idx.shape == (2, 16)
    np.testing.assert_array_equal(idx.numpy(), idx_j)
    assert rec.shape == (2, 3, 64, 64)
    assert _rel_l2(rec.numpy(), np.asarray(rec_j)) <= 1e-5
    assert abs(float(loss) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    assert _rel_l2(dec.numpy(), np.asarray(dec_j)) <= 1e-5


def test_bf16_model_against_jax_fp32(pair):
    jm, params, tm, imgs = pair
    x = jnp.array(imgs)
    z_j = jm.apply(params, x, method=lambda m, i: m._encode_features(i))
    idx_j = np.asarray(jm.apply(params, x, method=jv.VQGAN.encode_imgs))
    dec_j = jm.apply(params, jnp.array(idx_j),
                     method=jv.VQGAN.decode_indices)
    tb = tv.VQGAN(32, 64, dtype=torch.bfloat16)
    tb.load_state_dict(tm.state_dict())
    with torch.no_grad():
        z = tb._encode_features(_t(imgs))
        dec = tb.decode_indices(torch.from_numpy(idx_j.copy()))
        rec, loss = tb(_t(imgs))
    assert z.dtype == dec.dtype == rec.dtype == torch.bfloat16
    assert _rel_l2(z.float().numpy(), np.asarray(z_j)) <= 3e-2
    assert _rel_l2(dec.float().numpy(), np.asarray(dec_j)) <= 3e-2
    assert bool(torch.isfinite(rec).all()) and np.isfinite(float(loss))


@pytest.mark.parametrize("bf16", [False, True])
def test_nearest_codes_plain_at_width_256_matches_xla(bf16):
    rs = np.random.RandomState(5)
    z = l2_normalize(jnp.array(rs.randn(512, 256), jnp.float32))
    codes = l2_normalize(jnp.array(rs.randn(1024, 256), jnp.float32))
    if bf16:
        z, codes = z.astype(jnp.bfloat16), codes.astype(jnp.bfloat16)
    want = np.asarray(_nearest_codes_xla(z, codes))
    dt = torch.bfloat16 if bf16 else torch.float32
    got = _nearest_codes_reference(_t(z.astype(jnp.float32)).to(dt),
                                   _t(codes.astype(jnp.float32)).to(dt))
    np.testing.assert_array_equal(got.numpy(), want)


def test_reference_state_dict_drops_proj_out(pair):
    _, _, tm, _ = pair
    sd = dict(tm.state_dict())
    sd["encoder.model.15.proj_out.weight"] = torch.zeros(512, 512, 1, 1)
    fresh = tv.load_reference_state_dict(tv.VQGAN(32, 64), sd)
    assert torch.equal(fresh.codebook.embedding.weight,
                       tm.codebook.embedding.weight)
    with pytest.raises(RuntimeError):
        tv.VQGAN(32, 64).load_state_dict(sd)


def test_services_serve_the_cnn_tokenizer(pair):
    _, _, tm, imgs = pair
    idx = vq_encode_service(tm)(imgs, None)
    rec = vq_recon_service(tm)(imgs, None)
    assert idx.shape == (2, 16) and rec.shape == (2, 3, 64, 64)
    np.testing.assert_array_equal(idx.numpy(),
                                  tm.encode_imgs(_t(imgs)).numpy())


def _vqgan_cfg(tmp_path):
    from attention_models_torch.utils.config import load_config

    cfg = load_config(os.path.join(ROOT, "cfg", "vitvqgan.yaml"))
    for k, v in {"model.name": "vqgan", "codebook.codebook_dim": 32,
                 "codebook.codebook_size": 64, "dataset.name": "synthetic",
                 "dataset.preprocessing.resolution": 64,
                 "dataset.params.batch_size": 2,
                 "experiment.max_train_examples": 4,
                 "training.num_epochs": 1, "training.eval_fid": False,
                 "training.gradient_accumulation_steps": 1,
                 "lr_scheduler.params.warmup_steps": 0,
                 "experiment.output_dir": str(tmp_path / "out")}.items():
        cfg.set_path(k, v)
    return cfg


def test_build_model_and_trainer_train_the_cnn_tokenizer(tmp_path):
    """build_model's ``vqgan`` branch (unplaced, code width and codes from
    ``codebook``, bf16 compute under mixed_precision bf16) and one GAN
    micro-step of VQGANTrainer over it on the CPU."""
    from attention_models_torch.data.loaders import build_loader
    from attention_models_torch.models.factory import build_model
    from attention_models_torch.training.build_trainer import build_trainer
    from attention_models_torch.training.vqgan_trainer import VQGANTrainer

    cfg = _vqgan_cfg(tmp_path)
    model = build_model(cfg)
    assert isinstance(model, tv.VQGAN) and model.dtype == torch.bfloat16
    assert model.codebook.embedding.weight.shape == (64, 32)
    cfg.set_path("training.mixed_precision", "no")
    tr = build_trainer(cfg, build_model(cfg), build_loader(cfg), "cpu")
    assert isinstance(tr, VQGANTrainer)
    g0 = [p.detach().clone() for p in tr.g_params]
    img = tr.to_device(next(iter(tr.train_dl))[0])
    m = tr.train_step(img)
    assert all(np.isfinite(float(v)) for v in m.values())
    assert any(not torch.equal(a, p) for a, p in zip(g0, tr.g_params))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_trainer(cfg, build_model(cfg), build_loader(cfg))


def test_cli_loads_a_trainer_checkpoint_and_refuses_a_missing_one(
        tmp_path, pair, capsys):
    from attention_models_torch.inference import vqgan as cli

    _, _, tm, _ = pair
    path = tmp_path / "vqgan.pt"
    torch.save({"state_dict": tm.state_dict()}, path)
    args = ["--device", "cpu", "--resolution", "64", "--dim", "32",
            "--codebook-size", "64", "--batch", "2"]
    idx, rec = cli.main(args + ["--ckpt", str(path)])
    assert idx.shape == (2, 16) and rec.shape == (2, 3, 64, 64)
    imgs = np.random.RandomState(0).rand(2, 3, 64, 64).astype(np.float32)
    np.testing.assert_array_equal(idx.numpy(),
                                  tm.encode_imgs(_t(imgs)).numpy())
    assert "indices shape: (2, 16)" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="does not exist"):
        cli.main(args + ["--ckpt", str(tmp_path / "missing.pt")])
