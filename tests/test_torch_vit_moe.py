"""The port's ViT-MoE slice (attention_models_torch) against the JAX package
on the CPU: SwitchHeadAttention (dense and scatter output MoE, at a plain
length in fp32 and at a flash-sized length in bf16), AgentAttention, the
ViTMoE logits through ``vit_moe_from_jax``, one whole ``VitTrainer``
optimizer step on ``vit_moe`` against the JAX trainer's, the factory, the
CLI and chip_smoke.py's restated config.

Sizes: dim 128, 2 x 64 heads, E 4 (the dense dispatch) and 32 (the scatter),
top-2, capacity factor 2.0 (the shipped config's; 1.0 in the modules'
tests, where it drops pairs), depth 2, patch 8, 32 px (16 patches + the
class token), 10 classes, batch 2 (logits) or 4 (the trainer).
Tolerances, fp32: outputs and gradients within 1e-5 of their largest
magnitude; the step's loss 1e-5 relative, parameters and Adam moments as
in tests/test_torch_vit.py. bf16 against JAX: relative L2, with the bound
and the measured value stated in each test.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_models_torch.data.loaders import build_loader as t_build_loader
from attention_models_torch.models import attention as tattention
from attention_models_torch.models.attention import (
    AgentAttention as TAgent,
    SwitchHeadAttention as TSwitch,
)
from attention_models_torch.models.factory import build_model as t_build_model
from attention_models_torch.models.vit_moe import ViTMoE as TViTMoE
from attention_models_torch.ops.moe import topk_gate
from attention_models_torch.training.build_trainer import (
    build_trainer as t_build_trainer,
)
from attention_models_torch.training.vit_trainer import VitTrainer
from attention_models_torch.utils.config import Config
from attention_models_torch.utils.config import load_config as t_load_config
from attention_models_torch.utils.convert import (
    agent_attention_from_jax,
    switchhead_from_jax,
    vit_moe_from_jax,
)
from attention_models_tpu.data import build_loader as j_build_loader
from attention_models_tpu.models.attention import (
    AgentAttention as JAgent,
    SwitchHeadAttention as JSwitch,
)
from attention_models_tpu.models.factory import build_model as j_build_model
from attention_models_tpu.models.vit_moe import ViTMoE as JViTMoE
from attention_models_tpu.training import build_trainer as j_build_trainer
from attention_models_tpu.utils.config import load_config as j_load_config

ROOT = os.path.join(os.path.dirname(__file__), "..")
VIT_MOE = os.path.join(ROOT, "cfg", "vit_moe.yaml")
MODEL = dict(dim=128, image_size=32, patch_size=8, n_heads=2, d_head=64,
             depth=2, sel_experts=2, num_classes=10, capacity_factor=2.0)
SMALL = {"model.transformer.dim": 128, "model.transformer.n_heads": 2,
         "model.transformer.d_head": 64, "model.transformer.depth": 2,
         "model.transformer.patch_size": 8, "model.transformer.dropout": 0.0,
         "model.transformer.num_classes": 10,
         "dataset.name": "synthetic", "dataset.params.with_captions": False,
         "dataset.params.num_workers": 0, "dataset.params.pin_memory": False,
         "dataset.params.batch_size": 4,
         "dataset.params.persistent_workers": False,
         "dataset.params.train_test_split": None,
         "dataset.preprocessing.resolution": 32,
         "dataset.preprocessing.random_flip": False,
         "dataset.preprocessing.random_crop": False,
         "dataset.preprocessing.scale": 1.0,
         "experiment.max_train_examples": 8,
         "training.mixed_precision": "no", "training.num_epochs": 2,
         "lr_scheduler.params.warmup_steps": 0}
LR, B1, EPS = 3e-4, 0.9, 1e-8  # cfg/vit_moe.yaml's AdamW
BF16_BOUND = 3e-2  # relative L2 against JAX's fp32 (test_torch_vit.py's)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _close(got, want, what="", tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _switchhead(e, t, cf=1.0, seed=0, dtype=jnp.float32):
    x = np.random.RandomState(seed).randn(2, t, 128).astype(np.float32)
    jm = JSwitch(128, 2, 64, num_experts=e, sel_experts=2,
                 capacity_factor=cf, dtype=dtype)
    params = jm.init(jax.random.key(seed), jnp.asarray(x))["params"]
    tm = TSwitch(128, 2, 64, e, 2, capacity_factor=cf)
    tm.load_state_dict(switchhead_from_jax(jax.tree.map(np.asarray, params)),
                       strict=True)
    return x, jm, params, tm


@pytest.mark.parametrize("e,causal", [(4, False), (4, True), (32, False)])
def test_switchhead_fp32_matches_jax(e, causal):
    """t 16 (the plain attention); E 4 takes the dense output MoE, E 32 the
    scatter at capacity factor 1.0, which drops pairs here. The output and
    the gradients of sum(out * g) with respect to x and every parameter:
    W_d.0 gets none in either package (the unweighted output MoE)."""
    x, jm, params, tm = _switchhead(e, 16)
    g = np.random.RandomState(7).randn(2, 16, 128).astype(np.float32)

    def loss(p, xx):
        out = jm.apply({"params": p}, xx, causal=causal)
        return jnp.sum(out * g), out

    (_, want), (jgp, jgx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm(xt, causal=causal)
    _close(_np(out), want, "output")
    names = [k for k, _ in tm.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                [xt, *tm.parameters()], allow_unused=True)
    _close(_np(grads[0]), jgx, "dx")
    want_g = switchhead_from_jax(jax.tree.map(np.asarray, jgp))
    assert set(want_g) == set(names)
    for name, got in zip(names, grads[1:]):
        if name == "W_d.0.weight":
            assert got is None and not np.any(want_g[name].numpy())
        else:
            _close(_np(got), want_g[name].numpy(), name)


def _out_gate_flips(tm, jm_params, x, e, jdt, tdt):
    """Tokens (b, t) whose output-MoE selection differs between the port's
    gate and JAX's on the same input, in the given dtype."""
    _, sel_t = topk_gate(tm.W_d(torch.from_numpy(x).to(tdt)).unflatten(
        -1, (2, e)), 2)
    logits = jnp.asarray(x, jdt) @ jnp.asarray(jm_params["wd"]["kernel"], jdt)
    _, sel_j = jax.lax.top_k(logits.reshape(*x.shape[:2], 2, e), 2)
    return (np.sort(sel_t.numpy(), -1) != np.sort(np.asarray(sel_j), -1)
            ).any(axis=(-1, -2))


@pytest.mark.parametrize("e", [4, 32])
def test_switchhead_bf16_at_a_flash_length_matches_jax(e, monkeypatch):
    """t 128, bf16: the port takes the flash op (its plain version on the
    CPU, with the kernels' rounding points), JAX its XLA attention (its
    flash kernels run on a TPU only). Rows whose output-MoE selection
    flips between the two gates at a near tie are counted and left out;
    the rest within relative L2 2e-2 (measured 4.9e-3 at E 4 and 5.9e-3
    at E 32, no row flipped)."""
    calls = []
    flash = tattention.flash_attention_bthd
    monkeypatch.setattr(tattention, "flash_attention_bthd",
                        lambda *a, **k: calls.append(1) or flash(*a, **k))
    x, jm, params, tm = _switchhead(e, 128, dtype=jnp.bfloat16)
    want = np.asarray(jm.apply({"params": params},
                               jnp.asarray(x, jnp.bfloat16)
                               ).astype(jnp.float32))
    got = tm(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16 and calls == [1]
    flipped = _out_gate_flips(tm, params, x, e, jnp.bfloat16, torch.bfloat16)
    assert flipped.sum() <= 0.05 * flipped.size, int(flipped.sum())
    keep = ~flipped
    assert _rel_l2(_np(got)[keep], want[keep]) <= 2e-2


def test_agent_attention_fp32_matches_jax():
    """9 agents: 3 heads of 16; t 20 pools to 3 cells of uneven length
    (floor / ceil bounds); biases 0.3 and -0.2."""
    x = np.random.RandomState(2).randn(2, 20, 64).astype(np.float32)
    jm = JAgent(64, num_heads=3, dim_head=16, agent_num=9)
    params = dict(jax.tree.map(np.asarray,
                               jm.init(jax.random.key(2),
                                       jnp.asarray(x))["params"]))
    params["bias1"] = np.full((1, 1, 1, 1), 0.3, np.float32)
    params["bias2"] = np.full((1, 1, 1, 1), -0.2, np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = TAgent(64, 3, 16, agent_num=9)
    tm.load_state_dict(agent_attention_from_jax(params), strict=True)
    assert tm.dwc[1].weight.shape == (16, 1, 3, 3)
    _close(_np(tm(torch.from_numpy(x))), want)


def test_agent_attention_refuses_heads_unlike_the_agent_grid():
    with pytest.raises(ValueError, match=r"num_heads == int\(agent_num"):
        TAgent(64, num_heads=8, dim_head=16, agent_num=47)
    assert TAgent(64, num_heads=6, dim_head=16, agent_num=47).pool == 6


def _gate_selections(model, imgs):
    """Every gate's top-2 selection (b, t, heads, 2) in forward order."""
    sels, hooks = [], []
    for blk in model.encoder.layers:
        e = blk.moe.experts_kernel.shape[0]
        for lin in (blk.self_attn.W_s[0], blk.self_attn.W_d[0],
                    blk.moe.gate):
            hooks.append(lin.register_forward_hook(
                lambda m, i, o, e=e: sels.append(np.sort(topk_gate(
                    o.unflatten(-1, (-1, e)), 2)[1].numpy(), -1))))
    with torch.no_grad():
        out = model(imgs)
    for h in hooks:
        h.remove()
    return out, sels


@pytest.mark.parametrize("e", [4, 32])
def test_vit_moe_logits_match_jax(e):
    """fp32: within 1e-5 of max|logit|. bf16 compute over the same fp32
    parameters against JAX's fp32 logits, relative L2 within 3e-2. The
    (token, head) routing decisions that flip at a near tie (bf16 against
    the port's fp32, which equals JAX's) are counted: measured 5.90e-3
    with 0 of 340 decisions flipped at E 4, and 5.88e-3 with 6 of 340
    flipped at E 32 (the flips do not set the value: per image 4.8e-3 and
    6.8e-3). At most 5 % may flip."""
    imgs = np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32)
    jm = JViTMoE(**MODEL, n_experts=e)
    params = jm.init(jax.random.key(0), jnp.asarray(imgs))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(imgs)))
    sd = vit_moe_from_jax(jax.tree.map(np.asarray, params))
    tm = TViTMoE(**MODEL, n_experts=e)
    tm.load_state_dict(sd, strict=True)
    got, sel32 = _gate_selections(tm, torch.from_numpy(imgs))
    assert got.shape == (2, 10)
    _close(_np(got), want)
    tb = TViTMoE(**MODEL, n_experts=e, dtype=torch.bfloat16)
    tb.load_state_dict(sd, strict=True)
    out, sel16 = _gate_selections(tb, torch.from_numpy(imgs))
    assert out.dtype == torch.bfloat16 and len(sel16) == 3 * 2
    flips = [(a != b).any(-1) for a, b in zip(sel16, sel32)]
    flipped = sum(int(f.sum()) for f in flips)
    assert flipped <= 0.05 * sum(f.size for f in flips), flipped
    assert _rel_l2(_np(out), want) <= BF16_BOUND


def _cfgs(tmp_path, **extra):
    cfgs = []
    for load in (j_load_config, t_load_config):
        cfg = load(VIT_MOE)
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


def _close_all(got, want, what, free=None):
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


@pytest.mark.parametrize("e", [4, 32])
def test_train_step_matches_jax(tmp_path, e):
    """cfg/vit_moe.yaml cut to the sizes above, fp32, dropout 0, one
    optimizer step: loss, accuracy, Adam moments and every parameter.
    W_d.0's gradient is zero on both sides; weight decay 0.05 still moves
    it."""
    jcfg, tcfg = _cfgs(tmp_path, **{"model.transformer.n_experts": e})
    jt = _jax_trainer(jcfg, tmp_path)
    tt = t_build_trainer(tcfg, t_build_model(tcfg, "cpu"),
                         t_build_loader(tcfg), "cpu")
    assert isinstance(tt, VitTrainer)
    state = jax.tree.map(jnp.copy, jt.state)
    tt.model.load_state_dict(vit_moe_from_jax(state["params"]), strict=True)
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

    mu = port_keys(vit_moe_from_jax(_find(state["opt"], "mu")))
    nu = port_keys(vit_moe_from_jax(_find(state["opt"], "nu")))
    assert not any(mu[k].abs().sum() for k in mu if "W_d" in k)
    _close_all({k: st[p]["exp_avg"] for k, p in named.items()}, mu,
               "Adam mu")
    _close_all({k: st[p]["exp_avg_sq"] for k, p in named.items()}, nu,
               "Adam nu")
    free = {k: np.abs(mu[k].numpy()) / (1 - B1) < 100 * EPS for k in named}
    _close_all(named, port_keys(vit_moe_from_jax(state["params"])),
               "parameters", free=free)


def test_build_model_and_trainer_take_vit_moe(tmp_path):
    cfg = t_load_config(VIT_MOE)
    for k, v in {**SMALL, "experiment.output_dir": str(tmp_path)}.items():
        cfg.set_path(k, v)
    a = t_build_model(cfg, "cpu").state_dict()
    b = t_build_model(cfg, "cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["encoder.layers.1.moe.experts_kernel"].shape == (32, 128, 128)
    assert abs(float(a["pos_enc"].std()) - 1.0) < 0.1
    m = t_build_model(cfg, "cpu")
    layer = m.encoder.layers[0]
    assert (layer.moe.impl, layer.self_attn.impl) == ("scatter", "scatter")
    assert layer.moe.capacity_factor == 2.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_build_model(cfg)
    cfg.set_path("training.mixed_precision", "bf16")
    cfg.set_path("model.transformer.moe_impl", "dense")
    m = t_build_model(cfg, "cpu")
    assert m.dtype == torch.bfloat16
    assert m.class_embed.weight.dtype == torch.float32
    assert m.encoder.layers[0].moe.impl == "dense"
    tr = t_build_trainer(cfg, m, t_build_loader(cfg), "cpu")
    assert isinstance(tr, VitTrainer)


def test_cli_trains_vit_moe_on_cpu(tmp_path):
    from attention_models_torch.main import main

    args = [f"{k}={v}" for k, v in SMALL.items() if v is not None]
    tr = main([f"--config={VIT_MOE}", "--device", "cpu", *args,
               "dataset.params.train_test_split=null",
               "model.transformer.dropout=0.1",
               f"experiment.output_dir={tmp_path}"])
    assert tr.global_step == 4 and tr.opt.count == 4
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert '"loss"' in lines[0] and '"acc"' in lines[0]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_vit_moe_config_restates_vit_moe_yaml():
    """chip_smoke.py builds its configs in Python (the card's machine
    promises no PyYAML)."""
    mod = _chip_smoke()
    want = t_load_config(VIT_MOE)
    assert Config(mod.VIT_MOE_YAML).to_dict() == want.to_dict()
    for k, v in mod.VIT_OVERRIDES.items():
        want.set_path(k, v)
    want.set_path("model.transformer.dropout", 0.0)
    want.set_path("experiment.output_dir", "OUT")
    assert mod.vit_moe_config(0.0, "OUT").to_dict() == want.to_dict()
