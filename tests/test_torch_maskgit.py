"""The port's MaskGIT slice (attention_models_torch) against the JAX package
on the CPU: the GEGLU FFN's plain version, FeedForward, EncoderLayer, the
bidirectional transformer's logits and the whole iterative decode.

A small MaskGIT (dim 128, 2 x 64 heads, depth 2, mult 3 -> GEGLU inner 256,
vocab 64) over a small ViTVQGAN (dim 128, 32 px, patch 8 -> 16 tokens,
depth 1, codebook 64 x 16) is initialised in JAX and converted with
``maskgit_from_jax``. Tolerances, fp32: the FFN 2e-5 (as
tests/test_ops_ffn.py), modules and logits 1e-5, generated images 1e-4
(as tests/test_torch_vitvqgan.py); ids and per-step mask counts exactly
equal. bf16 FFN: relative L2 1e-3 against the JAX kernel (interpret mode),
whose rounding points the port's plain version keeps (H and g in fp32, y
rounded to bf16), and 1e-2 against JAX's ``_ffn_reference``, which also
rounds H and g to bf16 (4.6e-3 from its own kernel here).
"""

import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_models_torch.models import maskgit as tmg
from attention_models_torch.models.layers import FeedForward as TFeedForward
from attention_models_torch.models.transformer import (
    EncoderLayer as TEncoderLayer,
)
from attention_models_torch.ops.ffn import _ffn_reference as t_ffn_reference
from attention_models_torch.serving import maskgit_service
from attention_models_torch.utils import convert
from attention_models_tpu.models.layers import FeedForward as JFeedForward
from attention_models_tpu.models.maskgit import MaskGitTransformer as JMaskGit
from attention_models_tpu.models.transformer import (
    EncoderLayer as JEncoderLayer,
)
from attention_models_tpu.ops.ffn import _ffn_reference as j_ffn_reference
from attention_models_tpu.ops.ffn import fused_ffn as j_fused_ffn
from attention_models_tpu.ops.sampling import cosine_schedule as j_cosine

VIT = dict(dim=128, img_size=32, patch_size=8, n_heads=2, d_head=64, depth=1,
           mlp_dim=256, dropout=0.0)
VQ = dict(vit_params=VIT, codebook_params=dict(codebook_size=64,
                                               codebook_dim=16))
MG = dict(dim=128, vocab_size=64, n_heads=2, d_head=64, dec_depth=2, mult=3)
T, N_TOK = 4, 16


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _ffn_case(seed, dtype):
    rs = np.random.RandomState(seed)
    d, inner = 128, 256
    x = rs.randn(2, 32, d).astype(np.float32)
    w1 = (rs.randn(d, 2 * inner) / np.sqrt(d)).astype(np.float32)
    gamma = (1.0 + 0.1 * rs.randn(inner)).astype(np.float32)
    w2 = (rs.randn(inner, d) / np.sqrt(inner)).astype(np.float32)
    jx = jnp.array(x).astype(dtype)
    tx = _t(x).to(getattr(torch, jnp.dtype(dtype).name))
    return (jx, jnp.array(w1), jnp.array(gamma), jnp.array(w2)), (
        tx, _t(w1).T.contiguous(), _t(gamma), _t(w2).T.contiguous())


def test_ffn_reference_matches_jax_kernel_and_reference_fp32():
    jargs, targs = _ffn_case(0, jnp.float32)
    got = t_ffn_reference(*targs, 1e-5).numpy()
    kern = j_fused_ffn(*jargs, block_rows=16, interpret=True)
    ref = j_ffn_reference(*jargs, 1e-5)
    np.testing.assert_allclose(got, np.asarray(kern), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_ffn_reference_matches_jax_bf16():
    jargs, targs = _ffn_case(1, jnp.bfloat16)
    got = t_ffn_reference(*targs, 1e-5)
    assert got.dtype == torch.bfloat16
    kern = np.asarray(j_fused_ffn(*jargs, block_rows=16, interpret=True),
                      np.float32)
    assert _rel_l2(got.float().numpy(), kern) < 1e-3
    want = np.asarray(j_ffn_reference(*jargs, 1e-5), np.float32)
    assert _rel_l2(got.float().numpy(), want) < 1e-2


def _gamma(tree, key, sd):
    sd[f"{key}.gamma"] = _t(tree["gamma"])
    sd[f"{key}.beta"] = torch.zeros_like(sd[f"{key}.gamma"])


def _ff_sd(tree, p, sd):
    sd[f"{p}ff.0.weight"] = _t(tree["ff_in"]["kernel"]).T.contiguous()
    _gamma(tree["norm"], f"{p}ff.2", sd)
    sd[f"{p}ff.3.weight"] = _t(tree["ff_out"]["kernel"]).T.contiguous()
    return sd


@pytest.mark.parametrize("dim,mult", [(128, 3), (64, 2)])
def test_feed_forward_matches_jax(dim, mult):
    """(128, 3): inner 256 passes the fused gate (plain version on the CPU);
    (64, 2): inner 85 takes the unfused chain, on both sides."""
    x = np.random.RandomState(2).randn(2, 8, dim).astype(np.float32)
    jm = JFeedForward(dim, mult)
    params = jm.init(jax.random.key(0), jnp.array(x))["params"]
    tm = TFeedForward(dim, mult)
    tm.load_state_dict(_ff_sd(params, "", {}), strict=True)
    with torch.no_grad():
        got = tm(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply({"params": params},
                                                        jnp.array(x))),
                               atol=1e-5, rtol=1e-5)


def test_encoder_layer_matches_jax():
    x = np.random.RandomState(3).randn(2, 16, 128).astype(np.float32)
    jm = JEncoderLayer(128, 2, 64, 3)
    params = jm.init(jax.random.key(1), jnp.array(x))["params"]
    sd = {}
    _gamma(params["norm1"], "norm1", sd)
    _gamma(params["norm2"], "norm2", sd)
    for name, key in (("wq", "q.0"), ("wkv", "kv.0"), ("wo", "W_o")):
        convert._lin(params["self_attn"][name], f"self_attn.{key}", sd)
    _ff_sd(params["ff"], "feed_forward.", sd)
    tm = TEncoderLayer(128, 2, 64, 3)
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(_t(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jm.apply({"params": params}, jnp.array(x))),
        atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def pair():
    """(jax model, its params, the port model with the same weights, imgs)"""
    imgs = np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32)
    jm = JMaskGit(vq_config=VQ, dropout=0.0, **MG)
    params = jm.init(jax.random.key(0), jnp.array(imgs), jax.random.key(1),
                     method=JMaskGit.init_all)
    tm = tmg.MaskGitTransformer(vq_config=VQ, **MG)
    tm.load_state_dict(convert.maskgit_from_jax(params), strict=True)
    return jm, params, tm.eval(), imgs


def test_bidirectional_transformer_logits_match_jax(pair):
    jm, params, tm, _ = pair
    ids = np.random.RandomState(4).randint(0, 65, (2, N_TOK)).astype(np.int32)
    want = jm.apply(params, jnp.array(ids),
                    method=lambda m, x: m.bidirectional_transformer(x))
    with torch.no_grad():
        got = tm.bidirectional_transformer(torch.from_numpy(ids))
    assert got.shape == (2, N_TOK, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_decode_schedule_matches_jax_loop():
    for steps, num in ((4, 16), (18, 1024), (18, 200), (8, 100), (1, 5)):
        ts = jnp.linspace(0.0, 1.0, steps)
        want = [max(int(np.asarray(
            (j_cosine(ts[i]) * num).astype(jnp.int32))), 1)
            for i in range(steps)]
        temps = [float(np.asarray(
            jnp.asarray(steps - 1 - i).astype(jnp.float32) / steps))
            for i in range(steps)]
        got = tmg.decode_schedule(steps, num)
        assert [c for c, _ in got] == want
        assert [t for _, t in got] == temps


def _jax_generate(jm, params, rng, imgs, approx, num_masked):
    """JAX's images and final ids (intercepted at vq.decode_indices)."""
    seen = []

    def grab(next_fun, args, kwargs, context):
        if context.method_name == "decode_indices":
            seen.append(np.asarray(args[0]))
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(grab):
        out = jm.apply(params, rng,
                       imgs=None if imgs is None else jnp.array(imgs),
                       batch=2, num_masked=num_masked, timesteps=T,
                       approx_topk=approx, method=JMaskGit.generate)
    return np.asarray(out), seen[-1]


def _port_generate(tm, monkeypatch, **kw):
    """The port's images, final ids and per-step mask counts."""
    ids, counts = [], []
    real_mask, real_decode = tmg.lowest_score_mask, tm.vq.decode_indices

    def mask(scores, num):
        counts.append(num)
        return real_mask(scores, num)

    def decode(idx):
        ids.append(idx.numpy())
        return real_decode(idx)

    monkeypatch.setattr(tmg, "lowest_score_mask", mask)
    monkeypatch.setattr(tm.vq, "decode_indices", decode)
    out = tm.generate(**kw).numpy()
    monkeypatch.undo()
    return out, ids[-1], counts


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("inpaint", [False, True])
def test_generate_matches_jax_given_its_noise(pair, monkeypatch, approx,
                                              inpaint):
    """fp32 generate, JAX's per-step Gumbel draws handed to the port:
    gumbel(split(rng, T)[t], (b, n, k)) exact, (b, n, C) approx."""
    jm, params, tm, imgs = pair
    num_masked = 8 if inpaint else N_TOK
    rng = jax.random.key(2)
    k = math.ceil((1 - 0.9) * 64)
    shape = (2, N_TOK, 64 if approx else k)
    noise = [_t(jax.random.gumbel(r, shape, jnp.float32))
             for r in jax.random.split(rng, T)]
    want, want_ids = _jax_generate(jm, params, rng, imgs if inpaint else None,
                                   approx, num_masked)
    got, got_ids, counts = _port_generate(
        tm, monkeypatch, imgs=_t(imgs) if inpaint else None, batch=2,
        num_masked=num_masked, timesteps=T, approx_topk=approx, noise=noise)
    ts = jnp.linspace(0.0, 1.0, T)
    assert counts == [max(int(np.asarray((j_cosine(ts[i]) * num_masked)
                                         .astype(jnp.int32))), 1)
                      for i in range(T)]
    np.testing.assert_array_equal(got_ids, want_ids)
    if inpaint:  # the unmasked positions keep the image's own tokens
        own = tm.encode_to_indices(_t(imgs)).numpy()
        np.testing.assert_array_equal(got_ids[:, num_masked:],
                                      own[:, num_masked:])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("approx", [False, True])
def test_maskgit_service_rows_do_not_depend_on_the_batch(pair, monkeypatch,
                                                         approx):
    _, _, tm, _ = pair
    svc = maskgit_service(tm, timesteps=T, num_masked=N_TOK,
                          approx_topk=approx)
    ids = []
    real = tm.vq.decode_indices
    monkeypatch.setattr(tm.vq, "decode_indices",
                        lambda idx: ids.append(idx) or real(idx))
    batch = svc({}, [7, 8, 9])
    alone = svc({}, [8])
    assert batch.shape == (3, 3, 32, 32) and alone.shape == (1, 3, 32, 32)
    assert torch.equal(ids[0][1], ids[1][0])
    assert not torch.equal(ids[0][0], ids[0][1])  # seeds 7 and 8 differ


def test_inpainting_service_keeps_unmasked_tokens(pair, monkeypatch):
    _, _, tm, imgs = pair
    ids = []
    real = tm.vq.decode_indices
    monkeypatch.setattr(tm.vq, "decode_indices",
                        lambda idx: ids.append(idx) or real(idx))
    out = maskgit_service(tm, timesteps=T, num_masked=5, inpaint=True,
                          approx_topk=True)(imgs, [0, 1])
    assert out.shape == (2, 3, 32, 32) and bool(torch.isfinite(out).all())
    own = tm.encode_to_indices(_t(imgs))
    assert torch.equal(ids[0][:, 5:], own[:, 5:].long())


def test_kernels_switch_reaches_every_kernel_module(pair):
    _, _, tm, _ = pair
    flagged = [m for m in tm.modules() if hasattr(m, "kernels")]
    # transformer: itself (the fused head loss), init/final norms, per layer
    # norm1, attention, norm2, the FFN and its inner norm; the model; the
    # tokenizer's 4 * 2 + 2 + 2 + 1
    assert len(flagged) == (1 + 2 + 5 * MG["dec_depth"] + 1
                            + (8 * VIT["depth"] + 5))
    tm.use_kernels(False)
    try:
        assert not any(m.kernels for m in flagged)
    finally:
        tm.use_kernels(True)
    assert all(m.kernels for m in flagged)


def test_build_model_maskgit_from_config(monkeypatch, tmp_path):
    from attention_models_torch.models.factory import build_model
    from attention_models_torch.utils.config import load_config

    cfg = load_config("cfg/maskgit.yaml")
    for k, v in {"model.dim": 128, "model.depth": 1, "model.n_heads": 2,
                 "vitvqgan.transformer.depth": 1,
                 "dataset.preprocessing.resolution": 32,
                 "codebook.codebook_size": 64,
                 "vitvqgan.checkpoint": str(tmp_path / "none.pt")}.items():
        cfg.set_path(k, v)
    a, b = build_model(cfg, device="cpu"), build_model(cfg, device="cpu")
    assert isinstance(a, tmg.MaskGitTransformer)
    assert a.bidirectional_transformer.dtype == torch.float32  # "no"
    assert a.bidirectional_transformer.input_proj.weight.shape == (65, 128)
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)  # seeded
    assert not any(p.requires_grad for p in a.vq.parameters())
    cfg.set_path("training.mixed_precision", "bf16")
    bf = build_model(cfg, device="cpu").bidirectional_transformer
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("key, value", [
    ("training.remat", True), ("training.scan_layers", True),
    ("training.pipeline_microbatches", 4)])
def test_build_model_maskgit_refuses_unported_options(key, value):
    from attention_models_torch.models.factory import build_model
    from attention_models_torch.utils.config import load_config

    cfg = load_config("cfg/maskgit.yaml")
    cfg.set_path(key, value)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        build_model(cfg, device="cpu")


@pytest.mark.parametrize("quant", ["int8", "int8_wide"])
def test_build_model_maskgit_takes_quant(tmp_path, quant):
    from attention_models_torch.models.factory import build_model
    from attention_models_torch.utils.config import load_config

    cfg = load_config("cfg/maskgit.yaml")
    for k, v in {"model.dim": 128, "model.depth": 1, "model.n_heads": 2,
                 "vitvqgan.transformer.depth": 1,
                 "dataset.preprocessing.resolution": 32,
                 "codebook.codebook_size": 64, "model.quant": quant,
                 "vitvqgan.checkpoint": str(tmp_path / "none.pt")}.items():
        cfg.set_path(k, v)
    m = build_model(cfg, device="cpu")
    bt = m.bidirectional_transformer
    assert bt.quant == quant and m.vq.quant is None
    assert bt.decoder.layers[0].feed_forward.quant == quant
    assert bt.linear.quant == ("int8" if quant == "int8" else None)
    out = maskgit_service(m, timesteps=2, num_masked=N_TOK)({}, [0, 1])
    assert out.shape == (2, 3, 32, 32) and bool(torch.isfinite(out).all())


def test_quantized_head_loss_takes_the_logits():
    """Under int8 the head loss is cross-entropy over the quant_dot logits
    (JAX's eval loss of a quantized model), not the fused head loss."""
    from attention_models_torch.ops.sampling import cross_entropy_ignore_index

    bt = tmg.BiDirectionalTransformer(128, 64, N_TOK, 2, 64, 1, 3,
                                      quant="int8").eval()
    ids = torch.randint(0, 65, (2, N_TOK),
                        generator=torch.Generator().manual_seed(0))
    tgt = torch.where(ids % 3 == 0, ids % 64, -1)
    with torch.no_grad():
        loss = bt(ids, targets=tgt)
        logits = bt(ids)
    assert torch.allclose(loss, cross_entropy_ignore_index(logits, tgt))


def test_load_vq_checkpoint_kinds(tmp_path, caplog):
    from attention_models_torch.models.factory import load_vq_checkpoint
    from attention_models_torch.models.vitvqgan import ViTVQGAN

    assert load_vq_checkpoint(str(tmp_path / "missing.pt")) is None
    assert "not found" in caplog.text
    sd = ViTVQGAN(**VQ).state_dict()
    torch.save(sd, tmp_path / "VitVQGAN.pt")
    got = load_vq_checkpoint(str(tmp_path / "VitVQGAN.pt"))
    assert got.keys() == sd.keys()
    ema = {"pre_quant.weight": torch.ones_like(sd["pre_quant.weight"])}
    torch.save({"g": sd, "ema": ema, "step": 3}, tmp_path / "step_3.pt")
    got = load_vq_checkpoint(str(tmp_path))  # newest step of the directory
    assert torch.equal(got["pre_quant.weight"], ema["pre_quant.weight"])
    (tmp_path / "orbax").mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        load_vq_checkpoint(str(tmp_path / "orbax"))


def test_inference_cli_runs_on_cpu(tmp_path, capsys):
    from PIL import Image

    from attention_models_torch.inference.maskgit import main

    out = main(["--device", "cpu", "--resolution", "32", "--dim", "128",
                "--depth", "1", "--timesteps", "3", "--approx-topk",
                "--output", str(tmp_path / "gen.jpg")])
    assert out.shape == (1, 3, 32, 32) and (tmp_path / "gen.jpg").exists()
    rgb = (np.random.RandomState(0).rand(32, 32, 3) * 255).astype(np.uint8)
    Image.fromarray(rgb).save(tmp_path / "in.png")
    out = main(["--device", "cpu", "--resolution", "32", "--dim", "128",
                "--depth", "1", "--timesteps", "2", "--image",
                str(tmp_path / "in.png"), "--num-masked", "4",
                "--output", str(tmp_path / "inpaint.jpg")])
    assert out.shape == (1, 3, 32, 32) and (tmp_path / "inpaint.jpg").exists()
    out = main(["--device", "cpu", "--resolution", "32", "--dim", "128",
                "--depth", "1", "--timesteps", "2", "--quant", "int8",
                "--output", str(tmp_path / "q8.jpg")])
    assert out.shape == (1, 3, 32, 32) and bool(np.isfinite(out).all())
    assert "wrote" in capsys.readouterr().out
