"""Rules of the PyTorch/CUDA port (attention_models_torch):

- it imports neither JAX nor the JAX package, and chip_smoke.py neither;
  importing it needs neither Pillow nor PyYAML;
- entry points (the inference entry and CLIs, the training CLI, the
  trainers, ``build_model`` of the placed models) default to the card and
  raise without CUDA; device="cpu" runs the plain path;
- a kernel wrapper given CPU tensors runs its plain version and leaves its
  launch counter alone;
- on the kernel path a tensor that needs a gradient goes through the op's
  ``torch.autograd.Function`` (kernel forward, kernel or plain backward), so
  the graph is never cut; without one the forward kernel runs directly;
- chip_smoke.py's MaskGIT and Muse configs restate cfg/maskgit.yaml and
  cfg/muse.yaml;
- no ``except`` in the port or chip_smoke.py wraps a kernel launch or the
  kernels' build.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import attention_models_torch
from attention_models_torch.entry import entry
from attention_models_torch.longcontext import longcontext, make_inputs
from attention_models_torch.models.vitvqgan import vitvqgan_base
from attention_models_torch.ops import codebook, dispatch, ffn, flash_attention
from attention_models_torch.ops import layernorm as ln_ops
from attention_models_torch.ops import quant, sampling, xent

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import attention_models_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'attention_models_tpu', 'yaml', 'PIL')]\n"
        "assert len(mods) >= 30, mods\n"
        "assert {'attention_models_torch.ops.ring_attention', 'attention_models_torch.longcontext'} <= set(mods)\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert "attention_models_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "attention_models_tpu"}


def test_chip_smoke_refuses_to_run_without_cuda(monkeypatch):
    res = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


OVERFIT = str(ROOT / "cfg_exp" / "vitvqgan_overfit.yaml")


def _train_cli():
    from attention_models_torch.main import main

    main([f"--config={OVERFIT}"])


def _trainer():
    from attention_models_torch.data.loaders import build_loader
    from attention_models_torch.models.factory import build_model
    from attention_models_torch.training.build_trainer import build_trainer
    from attention_models_torch.utils.config import load_config

    cfg = load_config(OVERFIT)
    build_trainer(cfg, build_model(cfg), build_loader(cfg))


def _maskgit_cli():
    from attention_models_torch.inference.maskgit import main

    main(["--resolution", "32", "--dim", "128", "--depth", "1"])


def _maskgit_build_model():
    from attention_models_torch.models.factory import build_model
    from attention_models_torch.utils.config import load_config

    build_model(load_config(str(ROOT / "cfg" / "maskgit.yaml")))


def _muse_build_model():
    from attention_models_torch.models.factory import build_model
    from attention_models_torch.utils.config import load_config

    build_model(load_config(str(ROOT / "cfg" / "muse.yaml")))


def _muse_cli():
    from attention_models_torch.inference.muse import main

    main(["--resolution", "32", "--dim", "128", "--depth", "1"])


VIT_OVERFIT = str(ROOT / "cfg_exp" / "vit_overfit.yaml")


def _vit_build_model():
    from attention_models_torch.models.factory import build_model
    from attention_models_torch.utils.config import load_config

    build_model(load_config(str(ROOT / "cfg" / "vit.yaml")))


def _vit_trainer():
    from attention_models_torch.data.loaders import build_loader
    from attention_models_torch.models.factory import build_model
    from attention_models_torch.training.build_trainer import build_trainer
    from attention_models_torch.utils.config import load_config

    cfg = load_config(VIT_OVERFIT)
    build_trainer(cfg, build_model(cfg, "cpu"), build_loader(cfg))


def _vit_cli():
    from attention_models_torch.main import main

    main([f"--config={VIT_OVERFIT}"])


def _maskgit_trainer():
    from attention_models_torch.data.loaders import build_loader
    from attention_models_torch.models.factory import build_model
    from attention_models_torch.training.build_trainer import build_trainer
    from attention_models_torch.utils.config import load_config

    cfg = load_config(str(ROOT / "cfg_exp" / "maskgit_overfit.yaml"))
    build_trainer(cfg, build_model(cfg, "cpu"), build_loader(cfg))


@pytest.mark.parametrize("call", [
    lambda: entry(),
    lambda: vitvqgan_base(device=None, img_size=32),
    lambda: dispatch.resolve_device("cuda"),
    _train_cli,
    _trainer,
    _maskgit_cli,
    _maskgit_build_model,
    _maskgit_trainer,
    _muse_build_model,
    _muse_cli,
    lambda: vitvqgan_base(device=None, img_size=32, quant="int8"),
    _vit_build_model,
    _vit_trainer,
    _vit_cli,
    lambda: longcontext((128,)),
    lambda: make_inputs(128),
])
def test_card_entry_points_raise_without_cuda(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_cpu_entry_builds_main_path_shapes():
    fn, (model, imgs) = entry(device="cpu")
    assert imgs.shape == (8, 3, 256, 256) and imgs.dtype == torch.bfloat16
    assert model.dtype == torch.bfloat16 and model.num_patches == 1024
    assert next(model.parameters()).device.type == "cpu"


def test_cpu_device_runs_full_width_model():
    model = vitvqgan_base(img_size=32, device="cpu")
    imgs = torch.from_numpy(
        np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32))
    with torch.no_grad():
        rec, loss = model(imgs)
    assert rec.shape == (2, 3, 32, 32) and bool(torch.isfinite(rec).all())
    assert float(loss) > 0


def test_seeded_init_is_deterministic():
    a = vitvqgan_base(img_size=32, device="cpu", seed=3).state_dict()
    b = vitvqgan_base(img_size=32, device="cpu", seed=3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    # the JAX package's inits: unit-normal tables, zero biases, LN ones
    assert abs(float(a["codebook.embedding.weight"].std()) - 1.0) < 0.05
    assert float(a["decoder.fc.bias"].abs().max()) == 0.0
    assert float(a["encoder.pre_norm.weight"].min()) == 1.0


def _wrapper_cases():
    rs = np.random.RandomState(0)
    t = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))  # noqa: E731
    q8 = quant.quantize_weight
    q, kv, g = t(1, 16, 2, 64), t(1, 16, 2, 2, 64), t(1, 16, 2, 64)
    o, lse = flash_attention._flash_reference(q, kv, 0.125, False)
    qh, kh, vh, gh = (x.transpose(1, 2) for x in (q, kv[:, :, 0],
                                                  kv[:, :, 1], g))
    lse_h = lse.transpose(1, 2)
    delta_h = flash_attention.flash_delta(o.transpose(1, 2), gh)
    return [
        (ln_ops.layernorm, ln_ops._ln_reference,
         (t(8, 192), t(192), t(192)), (1e-5,)),
        (codebook.nearest_codes, codebook._nearest_codes_reference,
         (t(32, 16), t(64, 16)), ()),
        (flash_attention.flash_attention_bthd_kv,
         lambda q, kv: flash_attention._flash_reference(q, kv, 0.125, False),
         (t(1, 16, 2, 64), t(1, 16, 2, 2, 64)), ()),
        (ffn.fused_ln_mlp, ffn._ln_mlp_reference,
         (t(8, 64), t(64), t(64), t(96, 64), t(96), t(64, 96), t(64)),
         (1e-5,)),
        (lambda *a: flash_attention.flash_attention_bwd_kv(
            *a, scale=0.125, causal=False),
         flash_attention._flash_backward_reference,
         (q, kv, o, lse, g), (0.125, False)),
        (ffn.fused_ln_mlp_backward, ffn._ln_mlp_backward_reference,
         (t(8, 64), t(64), t(64), t(96, 64), t(96), t(64, 96), t(8, 64)),
         (1e-5,)),
        (ffn.fused_ffn, ffn._ffn_reference,
         (t(8, 128), t(512, 128), t(256), t(128, 256)), (1e-5,)),
        (lambda x, s: sampling.sample_epilogue_fused(x, seeds=s, step=3),
         lambda x, s: sampling._sample_epilogue_reference(x, seeds=s,
                                                          step=3),
         (t(2, 4, 64), torch.tensor([5, 6])), ()),
        (ffn.fused_ffn_backward, ffn._ffn_backward_reference,
         (t(8, 128), t(512, 128), t(256), t(128, 256), t(8, 128)), (1e-5,)),
        (xent.fused_head_xent, xent._head_xent_loss_reference,
         (t(8, 128), t(256, 128), torch.tensor([1, -1, 3, 4, -1, 6, 7, 8])),
         ()),
        (lambda h, w, tg, lse, c: xent.head_xent_backward(h, w, tg, lse, c),
         xent._head_xent_backward_reference,
         (t(8, 128), t(256, 128), torch.tensor([1, -1, 3, 4, -1, 6, 7, 8]),
          t(8), t(8)), ()),
        (quant.fused_ffn_q8, quant._ffn_q8_reference,
         (t(8, 128), q8(t(512, 128)), t(256), q8(t(128, 256))), (1e-5,)),
        (quant.fused_ffn_q8wide, quant._ffn_q8wide_reference,
         (t(8, 128), t(512, 128), t(256), q8(t(128, 256))), (1e-5,)),
        (quant.fused_ln_mlp_q8, quant._ln_mlp_q8_reference,
         (t(8, 128), t(128), t(128), q8(t(184, 128)), t(184),
          q8(t(128, 184)), t(128)), (1e-5,)),
        (ffn.fused_mlp, ffn._fused_mlp_reference,
         (t(8, 128), t(96, 128), t(96), t(128, 96), t(128)), ()),
        (ffn.fused_mlp_backward, ffn._fused_mlp_backward_reference,
         (t(8, 128), t(96, 128), t(96), t(128, 96), t(8, 128)), ()),
        (flash_attention.flash_attention_bthd,
         lambda q, k, v: flash_attention._flash_bthd_reference(
             q, k, v, 0.125, False), (q, kv[:, :, 0], kv[:, :, 1]), ()),
        (lambda *a: flash_attention.flash_attention_bwd_bthd(
            *a, scale=0.125, causal=False),
         flash_attention._flash_backward_bthd_reference,
         (q, kv[:, :, 0], kv[:, :, 1], o, lse, g), (0.125, False)),
        (lambda *a: flash_attention.flash_forward(*a, scale=0.125),
         flash_attention._flash_forward_reference, (qh, kh, vh),
         (0.125, False)),
        (lambda *a: flash_attention.flash_bwd_dkv(*a, scale=0.125),
         flash_attention._flash_bwd_dkv_reference,
         (qh, gh, lse_h, delta_h, kh, vh), (0.125, False)),
        (lambda *a: flash_attention.flash_bwd_dq(*a, scale=0.125),
         flash_attention._flash_bwd_dq_reference,
         (kh, vh, qh, gh, lse_h, delta_h), (0.125, False)),
    ]


LAUNCH_COUNTERS = [ln_ops.layernorm, codebook.nearest_codes,
                   flash_attention.flash_attention_bthd_kv, ffn.fused_ln_mlp,
                   flash_attention.flash_attention_bwd_kv,
                   ffn.fused_ln_mlp_backward, ffn.fused_ffn,
                   sampling.sample_epilogue_fused, ffn.fused_ffn_backward,
                   xent.fused_head_xent, xent.head_xent_backward,
                   quant.fused_ffn_q8, quant.fused_ffn_q8wide,
                   quant.fused_ln_mlp_q8, ffn.fused_mlp,
                   ffn.fused_mlp_backward, flash_attention.flash_attention_bthd,
                   flash_attention.flash_attention_bwd_bthd,
                   flash_attention.flash_forward, flash_attention.flash_bwd_dkv,
                   flash_attention.flash_bwd_dq]


@pytest.mark.parametrize("case", range(21))
def test_wrapper_on_cpu_runs_plain_and_counts_nothing(case):
    wrapper, plain, args, extra = _wrapper_cases()[case]
    before = [c.launches for c in LAUNCH_COUNTERS]
    got = wrapper(*args)
    want = plain(*args, *extra)
    assert [c.launches for c in LAUNCH_COUNTERS] == before
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert (g is None and w is None) or torch.equal(g, w)


def test_is_kernel_path_by_device():
    assert dispatch.is_kernel_path(torch.zeros(1)) is False
    assert dispatch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        dispatch.is_kernel_path(torch.zeros(1, device="meta"))


def test_inference_cli_runs_on_cpu(capsys):
    from attention_models_torch.inference.vitvqgan import main

    indices, rec = main(["--device", "cpu", "--resolution", "32",
                         "--batch", "2", "--seed", "1"])
    assert indices.shape == (2, 16) and rec.shape == (2, 3, 32, 32)
    assert "unique codes" in capsys.readouterr().out


def test_sync_is_exported():
    assert callable(attention_models_torch.sync)


def _fake_kernel_path(monkeypatch):
    """The kernel path without a card: every op module takes CPU tensors as
    if they were on the card, and each launch is replaced by its plain
    version computed outside autograd (a kernel's output has no graph of
    its own). Returns the list the fake launches append their names to."""
    calls = []

    def fake(name, fn):
        def run(*a, **k):
            calls.append(name)
            with torch.no_grad():
                return fn(*a, **k)
        return run

    for mod in (ln_ops, flash_attention, ffn, xent):
        monkeypatch.setattr(mod, "is_kernel_path", lambda t: True)
    monkeypatch.setattr(ln_ops, "_layernorm_kernel",
                        fake("layernorm", ln_ops._ln_reference))
    monkeypatch.setattr(flash_attention, "_flash_fwd_kernel",
                        fake("flash", flash_attention._flash_reference))
    monkeypatch.setattr(
        flash_attention, "flash_attention_bwd_kv",
        fake("flash_bwd", lambda *a, scale, causal:
             flash_attention._flash_backward_reference(*a, scale, causal)))
    monkeypatch.setattr(flash_attention, "_flash_bthd_kernel",
                        fake("flash_bthd", flash_attention._flash_bthd_reference))
    monkeypatch.setattr(
        flash_attention, "flash_attention_bwd_bthd",
        fake("flash_bthd_bwd", lambda *a, scale, causal:
             flash_attention._flash_backward_bthd_reference(*a, scale,
                                                            causal)))
    monkeypatch.setattr(
        flash_attention, "flash_forward",
        fake("flash16", lambda *a, scale, causal:
             flash_attention._flash_forward_reference(*a, scale, causal)))
    monkeypatch.setattr(
        flash_attention, "flash_bwd_dkv",
        fake("flash17", lambda *a, scale, causal:
             flash_attention._flash_bwd_dkv_reference(*a, scale, causal)))
    monkeypatch.setattr(
        flash_attention, "flash_bwd_dq",
        fake("flash18", lambda *a, scale, causal:
             flash_attention._flash_bwd_dq_reference(*a, scale, causal)))
    monkeypatch.setattr(ffn, "_ln_mlp_fwd_kernel",
                        fake("ln_mlp", ffn._ln_mlp_reference))
    monkeypatch.setattr(
        ffn, "fused_ln_mlp_backward",
        fake("ln_mlp_bwd", lambda *a, eps:
             ffn._ln_mlp_backward_reference(*a, eps)))
    monkeypatch.setattr(ffn, "_ffn_fwd_kernel",
                        fake("ffn", ffn._ffn_reference))
    monkeypatch.setattr(
        ffn, "fused_ffn_backward",
        fake("ffn_bwd", lambda *a, eps: ffn._ffn_backward_reference(*a, eps)))
    monkeypatch.setattr(ffn, "_mlp_fwd_kernel",
                        fake("mlp", ffn._fused_mlp_reference))
    monkeypatch.setattr(
        ffn, "fused_mlp_backward",
        fake("mlp_bwd", ffn._fused_mlp_backward_reference))
    monkeypatch.setattr(
        xent, "_head_xent_fwd_kernel",
        fake("head_xent", lambda h, w, b, tg: xent._head_xent_reference(
            h, w, tg, bias=b)))
    monkeypatch.setattr(
        xent, "head_xent_backward",
        fake("head_xent_bwd", lambda h, w, tg, lse, c, bias:
             xent._head_xent_backward_reference(h, w, tg, lse, c, bias)))
    return calls


def _grad_cases():
    rs = np.random.RandomState(1)
    t = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))  # noqa: E731
    return {
        "layernorm": (ln_ops.layernorm, ln_ops._ln_reference,
                      [t(8, 64), t(64), t(64)], (1e-5,), "_LayerNormFn"),
        "flash": (lambda q, kv: flash_attention.flash_attention_bthd_kv(
                      q, kv, scale=0.125)[0],
                  lambda q, kv: flash_attention._flash_reference(
                      q, kv, 0.125, False)[0],
                  [t(1, 16, 2, 64), t(1, 16, 2, 2, 64)], (), "_FlashKV"),
        "flash_bthd": (lambda q, k, v: flash_attention.flash_attention_bthd(
                           q, k, v, scale=0.125)[0],
                       lambda q, k, v: flash_attention._flash_bthd_reference(
                           q, k, v, 0.125, False)[0],
                       [t(1, 16, 2, 64), t(1, 16, 2, 64), t(1, 16, 2, 64)],
                       (), "_FlashBthd"),
        "flash_heads": (lambda q, k, v: flash_attention.flash_attention(
                            q, k, v, scale=0.125),
                        lambda q, k, v: flash_attention._flash_forward_reference(
                            q, k, v, 0.125, False)[0],
                        [t(1, 2, 16, 64), t(1, 2, 16, 64), t(1, 2, 16, 64)],
                        (), "_Flash"),
        "ln_mlp": (ffn.fused_ln_mlp, ffn._ln_mlp_reference,
                   [t(8, 64), t(64), t(64), t(96, 64), t(96), t(64, 96),
                    t(64)], (1e-5,), "_LnMlp"),
        "ffn": (ffn.fused_ffn, ffn._ffn_reference,
                [t(8, 128), t(512, 128) * 0.1, t(256), t(128, 256) * 0.1],
                (1e-5,), "_Ffn"),
        "mlp": (ffn.fused_mlp, ffn._fused_mlp_reference,
                [t(8, 128), t(96, 128) * 0.1, t(96), t(128, 96) * 0.1,
                 t(128)], (), "_MlpFn"),
        "head_xent": (lambda h, w, b: xent.fused_head_xent(h, w, tg, bias=b),
                      lambda h, w, b: xent._head_xent_loss_reference(
                          h, w, tg, bias=b),
                      [t(8, 128), t(256, 128) * 0.1, t(256) * 0.1], (),
                      "_HeadNll"),
    }


tg = torch.tensor([1, -1, 3, 4, -1, 6, 7, 8])
GRAD_OPS = {"layernorm": ("layernorm", []), "flash": ("flash", ["flash_bwd"]),
            "flash_bthd": ("flash_bthd", ["flash_bthd_bwd"]),
            "flash_heads": ("flash16", ["flash17", "flash18"]),
            "ln_mlp": ("ln_mlp", ["ln_mlp_bwd"]), "ffn": ("ffn", ["ffn_bwd"]),
            "mlp": ("mlp", ["mlp_bwd"]),
            "head_xent": ("head_xent", ["head_xent_bwd"])}


@pytest.mark.parametrize("op", list(GRAD_OPS))
def test_kernel_path_keeps_the_autograd_graph(monkeypatch, op):
    """Every kernel wrapper with an input that needs a gradient is reached
    through its autograd Function, whose backward gives the plain
    gradients; without a gradient the forward kernel runs directly."""
    wrapper, plain, args, extra, fn_name = _grad_cases()[op]
    want_args = [a.clone().requires_grad_(True) for a in args]
    want_out = plain(*want_args, *extra)
    cot = torch.ones_like(want_out)
    want = torch.autograd.grad(want_out, want_args, cot)

    calls = _fake_kernel_path(monkeypatch)
    got_args = [a.clone().requires_grad_(True) for a in args]
    out = wrapper(*got_args)
    # the Function is the output's own node, or (the head loss) sits under
    # the plain mean over the valid rows
    nodes, seen = [out.grad_fn], []
    while nodes:
        node = nodes.pop()
        seen.append(type(node).__name__)
        nodes += [f for f, _ in node.next_functions if f is not None]
    assert fn_name + "Backward" in seen
    got = torch.autograd.grad(out, got_args, cot)
    for a, b in zip(got, want):  # fp32; the explicit backwards sum in
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)  # other orders
    fwd, bwd = GRAD_OPS[op]
    assert calls[0] == fwd
    assert calls[1:] == bwd

    calls.clear()
    with torch.no_grad():
        out = wrapper(*got_args)
    assert out.grad_fn is None and calls == [fwd]


def test_chip_smoke_maskgit_config_restates_maskgit_yaml():
    """chip_smoke.py builds its MaskGIT config in Python (the card's
    machine promises no PyYAML); it must equal cfg/maskgit.yaml."""
    import importlib.util

    from attention_models_torch.utils.config import Config, load_config

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = Config(mod.MASKGIT_YAML)
    want = load_config(str(ROOT / "cfg" / "maskgit.yaml"))
    assert got.to_dict() == want.to_dict()
    # the training phase's config: the same, with its cuts of scale
    want.set_path("training.mixed_precision", "bf16")
    for k, v in mod.MASKGIT_TRAIN_OVERRIDES.items():
        want.set_path(k, v)
    want.set_path("experiment.output_dir", "OUT")
    assert mod.maskgit_train_config("OUT").to_dict() == want.to_dict()


def test_chip_smoke_muse_config_restates_muse_yaml():
    import importlib.util

    from attention_models_torch.utils.config import Config, load_config

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert (Config(mod.MUSE_YAML).to_dict()
            == load_config(str(ROOT / "cfg" / "muse.yaml")).to_dict())


def test_no_except_wraps_a_kernel_launch():
    """The port's except clauses (the flash gate's block probe, the optional
    Hugging Face tokenizer, the config reader) and none in chip_smoke.py;
    no try block around a launch, a fused op or the build."""
    kernel_calls = {"launch", "build", "library"}
    files = set()
    for path in [*sorted((ROOT / "attention_models_torch").rglob("*.py")),
                 ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Try) and node.handlers):
                continue
            files.add(path.relative_to(ROOT).as_posix())
            called = {c.func.attr if isinstance(c.func, ast.Attribute)
                      else getattr(c.func, "id", "")
                      for stmt in node.body for c in ast.walk(stmt)
                      if isinstance(c, ast.Call)}
            assert not called & kernel_calls, (path, called)
            assert not any(n.startswith(("fused_", "flash_attention",
                                         "sample_epilogue", "nearest_codes",
                                         "layernorm")) for n in called), (
                path, called)
    assert files == {"attention_models_torch/ops/flash_attention.py",
                     "attention_models_torch/models/text_encoder.py",
                     "attention_models_torch/utils/config.py"}
