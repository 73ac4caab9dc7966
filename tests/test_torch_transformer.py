"""The port's seq2seq Transformer slice (attention_models_torch) against the
JAX package on the CPU.

A small Transformer (dim 64, vocab 50, 2 x 32 heads, 2 + 2 layers: the
FFN's inner width int(64 * 8 / 3) = 170, which takes the unfused chain on
both sides, as the shipped 1365 does) is initialised in JAX and converted
with ``transformer_from_jax`` (a strict ``load_state_dict``). Tolerances,
fp32: the teacher-forced logits and ``encode`` within relative L2 1e-5;
``generate`` ids exactly equal given JAX's per-step Gumbel draws; the
cached decode step's logits against row t of the causal forward over the
buffer within 1e-5; ``SyntheticSeq2Seq`` items and the ``seq2seq``
loader's batches bit-equal; one ``TransformerTrainer`` micro-step's loss
and accuracy within relative 1e-5 and every gradient within relative L2
1e-4 of ``jax.value_and_grad`` of JAX's loss, both without the positional
encoding's dropout (its draws come from different generators).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from attention_models_torch.models.layers import AbsolutePositionalEmbedding
from attention_models_torch.models.transformer import Transformer
from attention_models_torch.utils import convert
from attention_models_tpu.models.layers import (
    AbsolutePositionalEmbedding as JAbsolutePositionalEmbedding,
)
from attention_models_tpu.models.transformer import Transformer as JTransformer

ROOT = os.path.join(os.path.dirname(__file__), "..")
OVERFIT = os.path.join(ROOT, "cfg_exp", "transformer_overfit.yaml")
TF = dict(dim=64, vocab_size=50, n_heads=2, d_head=32, enc_depth=2,
          dec_depth=2, n_classes=50)
B, TS = 3, 6


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _ids(seed, shape):
    return np.random.RandomState(seed).randint(3, 50, shape).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    jm = JTransformer(**TF)
    params = jax.jit(jm.init)(jax.random.key(0), jnp.array(_ids(0, (B, TS))),
                              jnp.array(_ids(1, (B, TS + 1))))
    tm = Transformer(**TF)
    tm.load_state_dict(convert.transformer_from_jax(params), strict=True)
    return jm, params, tm.eval()


def test_transformer_from_jax_covers_every_key(pair):
    _, params, tm = pair
    sd = convert.transformer_from_jax(params)
    assert set(sd) == set(tm.state_dict())
    assert "decoder.layers.1.cross_attn.kv.0.weight" in sd
    assert sd["linear.bias"].shape == (50,)


def test_forward_and_encode_match_jax(pair):
    jm, params, tm = pair
    src, tgt = _ids(2, (B, TS)), _ids(3, (B, TS + 1))
    want = jax.jit(jm.apply)(params, jnp.array(src), jnp.array(tgt))
    ctx_j = jax.jit(lambda p, s: jm.apply(p, s, method=JTransformer.encode))(
        params, jnp.array(src))
    with torch.no_grad():
        got = tm(torch.from_numpy(src), torch.from_numpy(tgt))
        ctx = tm.encode(torch.from_numpy(src))
    assert got.shape == (B, TS + 1, 50)
    assert _rel_l2(got.numpy(), np.asarray(want)) <= 1e-5
    assert _rel_l2(ctx.numpy(), np.asarray(ctx_j)) <= 1e-5


@pytest.mark.parametrize("max_len", [7, 12])
def test_generate_matches_jax_given_its_noise(pair, max_len):
    """JAX's draws, gumbel(split(rng, max_len)[t], (b, C)), handed to the
    port; rows past END are padded with END on both sides."""
    jm, params, tm = pair
    src = _ids(4, (B, TS))
    rng = jax.random.key(7)
    want = np.asarray(jm.apply(params, jnp.array(src), rng, max_len=max_len,
                               method=JTransformer.generate))
    noise = torch.stack([_t(jax.random.gumbel(r, (B, 50), jnp.float32))
                         for r in jax.random.split(rng, max_len)])
    got = tm.generate(torch.from_numpy(src), max_len, noise=noise)
    assert got.shape == (B, max_len + 1) and bool((got[:, 0] == 1).all())
    np.testing.assert_array_equal(got.numpy(), want)


def test_cached_step_equals_the_causal_forward_over_the_buffer(pair):
    """Row t of the decoder over the whole buffer (causal, bottom-right
    aligned at tq = tk, no init or final norm, as JAX's generate) against
    the KV-cached step t."""
    _, _, tm = pair
    src = torch.from_numpy(_ids(5, (B, TS)))
    buf = torch.from_numpy(_ids(6, (B, 9)))
    with torch.no_grad():
        ctx = tm.encode(src)
        x = tm.pos_enc(torch.nn.functional.embedding(
            buf, tm.dec_input_proj.weight))
        full = tm.linear(tm.decoder(x, ctx, causal=True))
        cache = tm.decoder.new_cache(B, 9, torch.float32, src.device)
        steps = torch.stack([tm.decode_step(buf[:, t:t + 1], t, ctx, cache)
                             for t in range(9)], 1)
    assert _rel_l2(steps.numpy(), full.numpy()) <= 1e-5


def test_absolute_positional_embedding_matches_jax():
    jm = JAbsolutePositionalEmbedding(dim=16, max_len=10)
    pos = jnp.arange(10)[None].repeat(2, 0)
    params = jm.init(jax.random.key(0), pos)
    tm = AbsolutePositionalEmbedding(16, 10)
    tm.load_state_dict({"emb.weight": _t(params["params"]["emb"][
        "embedding"])}, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(np.asarray(pos)))
    assert _rel_l2(got.numpy(), np.asarray(jm.apply(params, pos))) <= 1e-6


def _cfgs(tmp_path, **extra):
    from attention_models_torch.utils.config import load_config as t_load
    from attention_models_tpu.utils.config import load_config as j_load

    out = []
    for load in (j_load, t_load):
        cfg = load(OVERFIT)
        for k, v in extra.items():
            cfg.set_path(k, v)
        out.append(cfg)
    out[1].set_path("experiment.output_dir", str(tmp_path / "out"))
    return out


def test_seq2seq_items_and_batches_bit_equal_jax(tmp_path):
    from attention_models_torch.data.datasets import SyntheticSeq2Seq
    from attention_models_torch.data.loaders import build_loader as t_build
    from attention_models_tpu.data.datasets import (
        SyntheticSeq2Seq as JSyntheticSeq2Seq,
    )
    from attention_models_tpu.data.loaders import build_loader as j_build

    for i in (0, 5, 99):
        for a, b in zip(SyntheticSeq2Seq(100, 20, 1000, seed=3)[i],
                        JSyntheticSeq2Seq(100, 20, 1000, seed=3)[i]):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    jcfg, tcfg = _cfgs(tmp_path, **{"experiment.max_train_examples": 16})
    (jtr, jva), (ttr, tva) = j_build(jcfg), t_build(tcfg)
    for jdl, tdl in ((jtr, ttr), (jva, tva)):
        assert len(jdl) == len(tdl)
        for epoch in (0, 1):
            jdl.set_epoch(epoch)
            tdl.set_epoch(epoch)
            for (js, jt), (ts, tt) in zip(jdl, tdl):
                np.testing.assert_array_equal(ts, js)
                np.testing.assert_array_equal(tt, jt)
                assert ts.dtype == np.int32 and tt.shape == (ts.shape[0], 7)


def test_train_step_matches_jax(tmp_path):
    """The port trainer's first micro-step (its model's dropout rate set to
    0 on the instance) against jax.value_and_grad of JAX's PAD-masked CE
    at deterministic=True, on JAX's weights and one loader batch."""
    from attention_models_torch.data.loaders import build_loader
    from attention_models_torch.training.build_trainer import build_trainer
    from attention_models_torch.training.transformer_trainer import (
        TransformerTrainer,
        shift_right,
    )
    from attention_models_tpu.training.transformer_trainer import (
        _shift_right as j_shift_right,
    )

    _, tcfg = _cfgs(tmp_path)
    src, tgt = next(iter(build_loader(tcfg)[0]))
    tgt[0, -2:] = 0  # PAD positions the loss must ignore
    np.testing.assert_array_equal(shift_right(tgt), j_shift_right(tgt))
    jm = JTransformer(**TF)
    params = jax.jit(jm.init)(jax.random.key(3), jnp.array(src),
                              jnp.array(shift_right(tgt)))

    def loss_fn(p):
        logits = jm.apply(p, jnp.array(src), jnp.array(shift_right(tgt)))
        valid = (jnp.array(tgt) != 0).astype(jnp.float32)
        n = jnp.maximum(valid.sum(), 1.0)
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), jnp.array(tgt))
        acc = (jnp.argmax(logits, -1) == jnp.array(tgt)).astype(jnp.float32)
        return (ce * valid).sum() / n, (acc * valid).sum() / n

    (loss_j, acc_j), grads_j = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    for k, v in {"model.dim": 64, "model.vocab_size": 50, "model.n_heads": 2,
                 "model.d_head": 32, "model.enc_depth": 2,
                 "model.dec_depth": 2, "model.n_classes": 50}.items():
        tcfg.set_path(k, v)
    model = Transformer(**TF)
    model.load_state_dict(convert.transformer_from_jax(params), strict=True)
    tr = build_trainer(tcfg, model, build_loader(tcfg), "cpu")
    assert isinstance(tr, TransformerTrainer)
    tr.model.pos_enc.drop.p = 0.0
    seen = []
    tr.opt.step = seen.append
    m = tr.train_step(*tr.batch(src, tgt))
    assert abs(float(m["loss"]) - float(loss_j)) <= 1e-5 * float(loss_j)
    assert abs(float(m["acc"]) - float(acc_j)) <= 1e-5
    want = convert.transformer_from_jax(grads_j)
    names = [k for k, p in tr.model.named_parameters()]
    assert len(seen[0]) == len(names)
    for k, g in zip(names, seen[0]):
        assert _rel_l2(g.numpy(), want[k].numpy()) <= 1e-4, k


def test_cli_trains_evaluates_and_samples_on_cpu(tmp_path):
    """The overfit config's 4 micro-steps with its cadences: evaluate at
    step 2, on_sample at step 3."""
    import json

    from attention_models_torch.main import main

    out = tmp_path / "cli"
    tr = main([f"--config={OVERFIT}", "--device", "cpu",
               f"experiment.output_dir={out}"])
    assert tr.global_step == 4 and tr.opt.count == 4
    rows = [json.loads(line) for line in open(out / "metrics.jsonl")]
    val = [r for r in rows if "val_loss" in r]
    sample = [r for r in rows if "sample_token_match" in r]
    assert [r["step"] for r in val] == [2] and np.isfinite(val[0]["val_loss"])
    assert 0.0 <= val[0]["val_token_acc"] <= 1.0
    assert [r["step"] for r in sample] == [3]
    assert 0.0 <= sample[0]["sample_exact_match"] <= 1.0


def test_build_model_needs_cuda_unless_cpu(tmp_path):
    from attention_models_torch.models.factory import build_model

    _, tcfg = _cfgs(tmp_path)
    model = build_model(tcfg, device="cpu")
    assert isinstance(model, Transformer) and model.dtype == torch.float32
    a = build_model(tcfg, device="cpu").state_dict()
    assert all(torch.equal(a[k], v) for k, v in model.state_dict().items())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(tcfg)
