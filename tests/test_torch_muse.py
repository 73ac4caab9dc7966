"""The port's Muse slice (attention_models_torch) against the JAX package on
the CPU.

A small Muse (dim 128, depth 2, 2 x 64 heads, mult 4 -> GEGLU inner 341,
which takes the unfused and the quantized plain paths on both sides; CLIP
width 128, 2 layers, 2 heads, 77 tokens) over the MaskGIT tests' small
ViTVQGAN (dim 128, 32 px, patch 8 -> 16 tokens, codebook 64 x 16) is
initialised in JAX and converted with ``muse_from_jax``. Tolerances, fp32:
text embeddings and logits 1e-5 (relative L2, in each quant mode), images
1e-4 (as tests/test_torch_maskgit.py); token ids and per-step mask counts
exactly equal.
"""

import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_models_torch.models import muse as tmuse
from attention_models_torch.models.text_encoder import tokenize as t_tokenize
from attention_models_torch.serving import muse_service
from attention_models_torch.utils import convert
from attention_models_tpu.models.muse import MUSE as JMuse
from attention_models_tpu.models.text_encoder import tokenize as j_tokenize
from attention_models_tpu.ops.sampling import cosine_schedule as j_cosine

VIT = dict(dim=128, img_size=32, patch_size=8, n_heads=2, d_head=64, depth=1,
           mlp_dim=256, dropout=0.0)
VQ = dict(vit_params=VIT, codebook_params=dict(codebook_size=64,
                                               codebook_dim=16))
MU = dict(dim=128, n_heads=2, d_head=64, depth=2, mult=4, clip_width=128,
          clip_layers=2, clip_heads=2)
T, N_TOK, VOCAB = 4, 16, 64
PROMPTS = ["a stop sign", "two cats on a red sofa"]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_tokenize_matches_jax():
    texts = PROMPTS + ["", "UPPER case  spaces", " ".join(["w"] * 90)]
    got, want = t_tokenize(texts), j_tokenize(texts)
    assert got.dtype == np.int32 and got.shape == (5, 77)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def params():
    ids = jnp.array(j_tokenize(PROMPTS))
    imgs = jnp.array(np.random.RandomState(0).rand(2, 3, 32, 32), jnp.float32)
    return JMuse(vq_config=VQ, **MU).init(
        jax.random.key(0), ids, imgs, jax.random.key(1),
        method=JMuse.init_all)


@pytest.fixture(scope="module")
def ports(params):
    """The port model with JAX's weights, per quant mode."""
    sd = convert.muse_from_jax(params)
    out = {}
    for quant in (None, "int8", "int8_wide"):
        tm = tmuse.MUSE(vq_config=VQ, quant=quant, **MU)
        tm.load_state_dict(sd, strict=True)
        out[quant] = tm.eval()
    return out


def test_text_embeddings_match_jax(params, ports):
    ids = j_tokenize(PROMPTS)
    want = JMuse(vq_config=VQ, **MU).apply(params, jnp.array(ids),
                                           method=JMuse.encode_texts)
    with torch.no_grad():
        got = ports[None].encode_texts(torch.from_numpy(ids))
    assert got.shape == (2, 77, 128)
    assert _rel_l2(got.numpy(), np.asarray(want)) <= 1e-5


@pytest.mark.parametrize("quant", [None, "int8", "int8_wide"])
def test_decoder_logits_match_jax(params, ports, quant):
    rs = np.random.RandomState(4)
    ids = rs.randint(0, VOCAB + 1, (2, N_TOK)).astype(np.int32)
    ctx = rs.randn(2, 77, 128).astype(np.float32)
    want = JMuse(vq_config=VQ, quant=quant, **MU).apply(
        params, jnp.array(ids), jnp.array(ctx),
        method=lambda m, x, c: m.decoder(x, c))
    with torch.no_grad():
        got = ports[quant].decoder(torch.from_numpy(ids), _t(ctx))
    assert got.shape == (2, N_TOK, VOCAB)
    assert _rel_l2(got.numpy(), np.asarray(want)) <= 1e-5


def _jax_generate(params, quant, rng, approx):
    """JAX's images and final ids (intercepted at vq.decode_indices)."""
    seen = []

    def grab(next_fun, args, kwargs, context):
        if context.method_name == "decode_indices":
            seen.append(np.asarray(args[0]))
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(grab):
        out = JMuse(vq_config=VQ, quant=quant, **MU).apply(
            params, jnp.array(j_tokenize(PROMPTS)), rng, timesteps=T,
            approx_topk=approx, method=JMuse.generate)
    return np.asarray(out), seen[-1]


@pytest.mark.parametrize("quant,approx", [(None, False), (None, True),
                                          ("int8", False),
                                          ("int8_wide", True)])
def test_generate_matches_jax_given_its_noise(params, ports, monkeypatch,
                                              quant, approx):
    """fp32 generate with JAX's per-step Gumbel draws handed to the port:
    gumbel(split(rng, T)[t], (b, n, k)) exact, (b, n, C) approx. Quantized,
    the port also takes JAX's text embeddings: int8 codes are a step
    function, and the two text towers' 3e-6 difference (held to 1e-5 above)
    flips a code of the cross-attention's kv projection, which moves these
    logits by 1e-2 (the decoders agree to 1e-7 on one context)."""
    rng = jax.random.key(2)
    k = math.ceil((1 - 0.9) * VOCAB)
    shape = (2, N_TOK, VOCAB if approx else k)
    noise = [_t(jax.random.gumbel(r, shape, jnp.float32))
             for r in jax.random.split(rng, T)]
    want, want_ids = _jax_generate(params, quant, rng, approx)
    tm = ports[quant]
    if quant is not None:
        text = _t(JMuse(vq_config=VQ, **MU).apply(
            params, jnp.array(j_tokenize(PROMPTS)), method=JMuse.encode_texts))
        monkeypatch.setattr(tm, "encode_texts", lambda ids: text)
    counts, ids = [], []
    real_mask, real_decode = tmuse.lowest_score_mask, tm.vq.decode_indices
    monkeypatch.setattr(tmuse, "lowest_score_mask",
                        lambda s, num: counts.append(num) or real_mask(s, num))
    monkeypatch.setattr(tm.vq, "decode_indices",
                        lambda idx: ids.append(idx.numpy()) or real_decode(idx))
    got = tm.generate(torch.from_numpy(t_tokenize(PROMPTS)), timesteps=T,
                      approx_topk=approx, noise=noise).numpy()
    ts = jnp.linspace(0.0, 1.0, T)
    assert counts == [max(int(np.asarray((j_cosine(ts[i]) * N_TOK)
                                         .astype(jnp.int32))), 1)
                      for i in range(T)]
    np.testing.assert_array_equal(ids[-1], want_ids)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("approx", [False, True])
def test_muse_service_rows_do_not_depend_on_the_batch(ports, monkeypatch,
                                                      approx):
    tm = ports["int8"]
    svc = muse_service(tm, timesteps=T, approx_topk=approx)
    ids = []
    real = tm.vq.decode_indices
    monkeypatch.setattr(tm.vq, "decode_indices",
                        lambda idx: ids.append(idx) or real(idx))
    text = t_tokenize(PROMPTS + ["a blue bird"])
    batch = svc(text, [7, 8, 9])
    alone = svc(text[1:2], [8])
    assert batch.shape == (3, 3, 32, 32) and alone.shape == (1, 3, 32, 32)
    assert torch.equal(ids[0][1], ids[1][0])
    assert not torch.equal(ids[0][0], ids[0][2])


def test_generate_quantizes_each_weight_once(ports, monkeypatch):
    from attention_models_torch.ops import quant as tq

    calls = []
    real = tq.quantize_weight
    monkeypatch.setattr(tq, "quantize_weight",
                        lambda w: calls.append(w.shape) or real(w))
    ports["int8"].generate(torch.from_numpy(t_tokenize(PROMPTS[:1])),
                           timesteps=3, approx_topk=True)
    # per decoder layer wq, wkv, wo twice (self, cross) and the FFN's two;
    # the head: each once for the 3 steps
    assert len(calls) == MU["depth"] * (2 * 3 + 2) + 1


def test_vitvqgan_int8_recon_matches_jax():
    """The tokenizer itself under model.quant int8: fp32 recon (the
    attention projections through quant_dot, the blocks' LN + MLP through
    kernel 21's plain version) and codebook indices."""
    from attention_models_torch.models.vitvqgan import ViTVQGAN as TViTVQGAN
    from attention_models_tpu.models.vitvqgan import ViTVQGAN as JViTVQGAN

    imgs = np.random.RandomState(1).rand(2, 3, 32, 32).astype(np.float32)
    jm = JViTVQGAN(vit_params=VIT, codebook_params=VQ["codebook_params"],
                   quant="int8")
    params = jm.init(jax.random.key(0), jnp.array(imgs))
    rec_j, _ = jm.apply(params, jnp.array(imgs))
    idx_j = jm.apply(params, jnp.array(imgs), method=JViTVQGAN.encode_imgs)
    tm = TViTVQGAN(VIT, VQ["codebook_params"], quant="int8")
    tm.load_state_dict(convert.from_jax_params(params), strict=True)
    with torch.no_grad():
        rec, _ = tm(_t(imgs))
        idx = tm.encode_imgs(_t(imgs))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    assert _rel_l2(rec.numpy(), np.asarray(rec_j)) <= 1e-5


def _small_muse_cfg(tmp_path):
    from attention_models_torch.utils.config import load_config

    cfg = load_config("cfg/muse.yaml")
    for k, v in {"model.dim": 128, "model.decoder.depth": 1,
                 "model.decoder.n_heads": 2, "model.encoder.width": 128,
                 "model.encoder.layers": 1, "model.encoder.heads": 2,
                 "vitvqgan.transformer.depth": 1,
                 "dataset.preprocessing.resolution": 32,
                 "codebook.codebook_size": 64,
                 "vitvqgan.checkpoint": str(tmp_path / "none.pt")}.items():
        cfg.set_path(k, v)
    return cfg


def test_build_model_muse_from_config(tmp_path):
    from attention_models_torch.models.factory import build_model

    cfg = _small_muse_cfg(tmp_path)
    a, b = build_model(cfg, device="cpu"), build_model(cfg, device="cpu")
    assert isinstance(a, tmuse.MUSE) and a.dtype == torch.float32  # "no"
    assert a.decoder.token_emb.weight.shape == (65, 128)
    assert a.decoder.decoder.layers[0].feed_forward.ff[0].weight.shape == (
        2 * int(128 * 6 * 2 / 3), 128)
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)  # seeded
    assert not any(p.requires_grad for p in a.vq.parameters())
    cfg.set_path("training.mixed_precision", "bf16")
    cfg.set_path("model.quant", "int8_wide")
    bf = build_model(cfg, device="cpu")
    assert bf.dtype == torch.bfloat16 and bf.quant == "int8_wide"
    out = muse_service(bf, timesteps=2, approx_topk=True)(
        t_tokenize(PROMPTS), [0, 1])
    assert out.shape == (2, 3, 32, 32) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("key,value,err", [
    ("model.name", "muse_vqgan", NotImplementedError),
    ("training.scan_layers", True, NotImplementedError),
    ("model.quant", "int4", ValueError)])
def test_build_model_muse_refuses(tmp_path, key, value, err):
    from attention_models_torch.models.factory import build_model

    cfg = _small_muse_cfg(tmp_path)
    cfg.set_path(key, value)
    with pytest.raises(err):
        build_model(cfg, device="cpu")


@pytest.mark.parametrize("name", ["muse", "maskgit"])
def test_build_trainer_still_refuses_quant(tmp_path, name):
    from attention_models_torch.training.build_trainer import build_trainer
    from attention_models_torch.utils.config import load_config

    cfg = load_config(f"cfg/{name}.yaml")
    cfg.set_path("model.quant", "int8")
    with pytest.raises(ValueError, match="inference-only"):
        build_trainer(cfg, None, None, "cpu")


def test_inference_cli_runs_on_cpu(tmp_path, capsys):
    from attention_models_torch.inference.muse import main

    out = main(["--device", "cpu", "--resolution", "32", "--dim", "128",
                "--depth", "1", "--heads", "2", "--mult", "4",
                "--timesteps", "2", "--quant", "int8_wide", "--approx-topk",
                "--prompt", "a red cube", "--output", str(tmp_path / "m.jpg")])
    assert out.shape == (1, 3, 32, 32) and (tmp_path / "m.jpg").exists()
    assert "wrote" in capsys.readouterr().out
