"""The port's ViTVQGAN (attention_models_torch) against the JAX model.

A small ViTVQGAN (dim 128, img 32, patch 8, 2 x 64 heads, depth 2, mlp 256,
codebook 64 x 16) is initialised in JAX, converted with ``from_jax_params``
and run through both on the CPU in fp32. Tolerances: reconstruction
atol/rtol 1e-4 (as tests/test_parity_vision.py), loss 1e-5, codebook
indices exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_models_torch.models.vitvqgan import (
    ViTVQGAN as TorchViTVQGAN,
    vitvqgan_base as torch_vitvqgan_base,
)
from attention_models_torch.serving import vq_encode_service, vq_recon_service
from attention_models_torch.utils.convert import from_jax_params
from attention_models_tpu.models.vitvqgan import (
    ViTVQGAN as JaxViTVQGAN,
    vitvqgan_base as jax_vitvqgan_base,
)
from attention_models_tpu.utils.torch_convert import (
    convert_vitvqgan,
    state_dict_to_numpy,
)

VIT = dict(dim=128, img_size=32, patch_size=8, n_heads=2, d_head=64, depth=2,
           mlp_dim=256, dropout=0.0)
CB = dict(codebook_size=64, codebook_dim=16)


@pytest.fixture(scope="module")
def pair():
    """(jax model, its params, the port model with the same weights, imgs)"""
    imgs = np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32)
    jm = JaxViTVQGAN(vit_params=VIT, codebook_params=CB)
    params = jm.init(jax.random.key(0), jnp.array(imgs))
    tm = TorchViTVQGAN(VIT, CB)
    tm.load_state_dict(from_jax_params(params), strict=True)
    return jm, params, tm.eval(), imgs


def test_forward_matches_jax(pair):
    jm, params, tm, imgs = pair
    rec_j, loss_j = jm.apply(params, jnp.array(imgs))
    with torch.no_grad():
        rec_t, loss_t = tm(torch.from_numpy(imgs))
    assert rec_t.shape == (2, 3, 32, 32)
    np.testing.assert_allclose(rec_t.numpy(), np.asarray(rec_j),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=1e-5)


def test_encode_imgs_indices_equal_jax(pair):
    jm, params, tm, imgs = pair
    idx_j = jm.apply(params, jnp.array(imgs), method=JaxViTVQGAN.encode_imgs)
    with torch.no_grad():
        idx_t = tm.encode_imgs(torch.from_numpy(imgs))
    assert idx_t.dtype == torch.int32 and idx_t.shape == (2, 16)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))


def test_decode_indices_matches_jax(pair):
    jm, params, tm, _ = pair
    idx = np.random.RandomState(1).randint(0, 64, (2, 16)).astype(np.int32)
    dec_j = jm.apply(params, jnp.array(idx), method=JaxViTVQGAN.decode_indices)
    with torch.no_grad():
        dec_t = tm.decode_indices(torch.from_numpy(idx))
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j),
                               atol=1e-4, rtol=1e-4)


def test_plain_switch_reaches_every_kernel_module(pair):
    """use_kernels(False) flips every module that calls a kernel wrapper to
    the plain versions; on the CPU both routes are the plain versions."""
    _, _, tm, imgs = pair
    x = torch.from_numpy(imgs)
    flagged = [m for m in tm.modules() if hasattr(m, "kernels")]
    # per block: norm1, self_attn, norm2, the block (ln_mlp); plus patch
    # norms, two pre_norms, the codebook
    assert len(flagged) == 4 * 2 * VIT["depth"] + 2 + 2 + 1
    with torch.no_grad():
        rec_a, _ = tm(x)
        tm.use_kernels(False)
        try:
            assert not any(m.kernels for m in flagged)
            rec_b, _ = tm(x)
        finally:
            tm.use_kernels(True)
    assert all(m.kernels for m in flagged)
    np.testing.assert_array_equal(rec_a.numpy(), rec_b.numpy())


def test_services_match_model(pair):
    _, _, tm, imgs = pair
    with torch.no_grad():
        rec, _ = tm(torch.from_numpy(imgs))
        idx = tm.encode_imgs(torch.from_numpy(imgs))
    np.testing.assert_array_equal(
        vq_recon_service(tm)(imgs, [0, 1]).numpy(), rec.numpy())
    np.testing.assert_array_equal(
        vq_encode_service(tm)(imgs, [0, 1]).numpy(), idx.numpy())


def test_bf16_forward_close_to_jax(pair):
    """bf16 towers on both sides (the main path's dtype): rounding happens
    at other places, so only a bf16-scale bound holds."""
    jm, params, tm, imgs = pair
    jb = JaxViTVQGAN(vit_params=VIT, codebook_params=CB, dtype=jnp.bfloat16)
    rec_j, _ = jb.apply(params, jnp.array(imgs))
    tb = TorchViTVQGAN(VIT, CB)
    tb.load_state_dict(tm.state_dict())
    with torch.no_grad():
        rec_t, _ = tb.to(torch.bfloat16).eval()(torch.from_numpy(imgs))
    a = rec_t.float().numpy()
    b = np.asarray(rec_j, np.float32)
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 5e-2


def test_state_dict_roundtrips_through_torch_convert(pair):
    _, params, tm, _ = pair
    back = convert_vitvqgan(state_dict_to_numpy(tm.state_dict()), depth=2)
    want = jax.tree_util.tree_map(np.asarray, params["params"])
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_b) == len(flat_w)
    for path, leaf in flat_b:
        np.testing.assert_array_equal(leaf, flat_w[path])


def test_full_width_structure_loads_strict():
    """vitvqgan_base's JAX tree (shapes only) -> from_jax_params -> a strict
    load into the port's vitvqgan_base: every key and shape lines up."""
    jm = jax_vitvqgan_base(img_size=256)
    shapes = jax.eval_shape(jm.init, jax.random.key(0),
                            jnp.zeros((1, 3, 256, 256), jnp.float32))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = from_jax_params(zeros)
    tm = torch_vitvqgan_base(device="cpu")
    tm.load_state_dict(sd, strict=True)
    assert tm.decoder.decoder.layers[5].feed_forward[0].weight.shape == (1368, 512)
    assert tm.codebook.embedding.weight.shape == (8192, 32)
    assert "encoder.to_patch_embedding.1.weight" in sd
    assert sd["encoder.encoder.layers.0.self_attn.kv.0.weight"].shape == (1024, 512)
