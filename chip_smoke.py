"""Chip smoke test of the PyTorch/CUDA port (attention_models_torch).

    python3 chip_smoke.py [--out results.json]

Needs one Hopper card. Phases, one line each (any failure raises):
  1. device   the card's name, nvidia-smi's name and power limit
  2. build    nvcc of attention_models_torch/csrc/*.cu (one process a file)
  3. kernels  each kernel at the main path's shapes against its plain
              version on the card, in each dtype it takes, with kernel,
              plain and library (one PyTorch call; for a backward kernel
              its forward + backward) times and the bound
  4. block    one full-width ViTVQGANBlock (b 8, t 1024, d 512, bf16
              compute over fp32 parameters), forward + backward with the
              kernels against the same block on the plain versions: dx and
              every parameter gradient (the gate on the autograd wiring)
  5. main     the serving path: entry() (ViTVQGAN 256 px, bf16, batch 8,
              seeded weights), 3 requests through vq_recon_service and 1
              through vq_encode_service; every kernel's launch count must
              rise by its per-forward count; the same weights through the
              plain path on the card; recon imgs/s; recon imgs/s with the
              wrappers' direct no-grad launch against their autograd
              Functions (10 alternating pairs); device time by kernel
              over 3 traced recon requests (torch.profiler)
  6. golden   fp32 encode_imgs, kernels against plain, TF32 off
  7. train    the training path: VQGANTrainer.train() on cfg/vitvqgan.yaml
              (restated in Python, TRAIN_OVERRIDES: synthetic data, 16
              examples, 2 epochs = 4 micro-steps, 2 optimizer steps);
              exact launch deltas per micro-step, finite losses, G and D
              parameters changing at the optimizer steps only, micro-step
              time, imgs/s, peak memory; device time by kernel over 2
              traced micro-steps
The last two lines are the per-kernel JSON and {"ok": true, "device": ...}.

Tolerances (kernel against plain on the card):
  - bf16: relative L2 error |a - b| / |b| <= 1e-2 (bf16 rounds at ~4e-3);
  - fp32: relative L2 error <= 1e-5 (summation order only);
  - codebook indices: equal wherever the plain best/second-best distance gap
    exceeds 1e-5, and the chosen code's distance within 1e-5 of the minimum
    everywhere (fp32 sums in another order move distances by ~1 ulp);
  - whole model, bf16: the encoder output z and the decoder on identical
    indices within relative L2 2e-2 (1e-2 per op, compounded over 6 blocks);
    whole-model indices are reported, not gated: near-ties flip codes at bf16
    resolution;
  - whole model, fp32 indices: agree on >= 99.9 % of tokens, and every
    disagreement lies at a plain top-2 distance gap <= 1e-4;
  - backward kernels: relative L2 <= 2e-2 in bf16 (P and dS, G and dH are
    rounded to bf16 before the products that take them, as in the TPU
    kernels) and <= 1e-5 in fp32 (summation order only), on every output;
  - the full-width block: dx and every parameter gradient within relative
    L2 2e-2 of the plain path. No whole-model gradient is gated: codebook
    near-ties flip indices between the two paths.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # fp32 outside the tensor cores
BF16_TOL, F32_TOL, MODEL_BF16_TOL = 1e-2, 1e-5, 2e-2
BWD_BF16_TOL = 2e-2

# cfg/vitvqgan.yaml as PyYAML reads it (the card's machine promises no
# PyYAML); tests/test_torch_training.py holds the two equal
VITVQGAN_YAML = {
    "experiment": {
        "project_name": "vitvqgan", "exp_name": "run1",
        "max_train_examples": 1000000, "save_every": 500, "eval_every": 500,
        "sample_every": 500, "log_every": 100, "log_level": "info",
        "resume_path_from_checkpoint": None, "wandb": False},
    "codebook": {"codebook_dim": 32, "beta": 0.25, "codebook_size": 8192},
    "model": {"name": "vitvqgan", "transformer": {
        "dim": 512, "patch_size": 8, "n_heads": 8, "d_head": 64, "depth": 6,
        "dropout": 0.0, "mlp_dim": 2048}},
    "dataset": {
        "name": "coco",
        "params": {"train_path": "/datasets/coco2017", "val_path": None,
                   "num_workers": 4, "pin_memory": True, "batch_size": 8,
                   "persistent_workers": True, "shuffle": True,
                   "train_test_split": 0.9},
        "preprocessing": {"resolution": 256, "center_crop": False,
                          "random_flip": True, "random_crop": True,
                          "mean": None, "std": None, "scale": 0.66}},
    "optimizer": {"name": "adam", "params": {
        "learning_rate": 0.0001, "beta1": 0.9, "beta2": 0.999,
        "weight_decay": 0.0, "epsilon": "1e-8"}},
    "lr_scheduler": {"name": "timm_cosine", "params": {
        "learning_rate": "${optimizer.params.learning_rate}",
        "warmup_steps": 50000, "decay_steps": 100000}},
    "losses": {"per_loss_weight": 1, "adv_loss_weight": 0.1,
               "logit_laplace_weight": 1},
    "training": {"gradient_accumulation_steps": 2, "mixed_precision": "bf16",
                 "seed": 42, "num_epochs": 200, "max_grad_norm": 1.0,
                 "tensor_parallel": 1},
}
TRAIN_OVERRIDES = {"dataset.name": "synthetic",
                   "experiment.max_train_examples": 16,
                   "training.num_epochs": 2}
# kernel launches per training micro-step: 6 + 6 blocks, 16 LayerNorms
# (patch norm1 + norm2, two pre_norms, 12 norm1s), one codebook lookup;
# each block's attention and ln_mlp backward once
PER_MICRO_STEP = {"flash_attention_bthd_kv": 12, "ln_mlp": 12,
                  "layernorm": 16, "nearest_codes": 1,
                  "flash_attention_bwd_kv": 12, "ln_mlp_bwd": 12}


def training_config(output_dir: str):
    """cfg/vitvqgan.yaml with TRAIN_OVERRIDES, outputs under output_dir."""
    from attention_models_torch.utils.config import Config

    cfg = Config(json.loads(json.dumps(VITVQGAN_YAML)))
    for k, v in TRAIN_OVERRIDES.items():
        cfg.set_path(k, v)
    cfg.set_path("experiment.output_dir", output_dir)
    return cfg


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 2

    import numpy as np

    import attention_models_torch as amt
    from attention_models_torch.entry import entry
    from attention_models_torch.models.vitvqgan import vitvqgan_base
    from attention_models_torch.ops import _build, dispatch
    from attention_models_torch.ops import ffn as ffn_mod
    from attention_models_torch.ops import flash_attention as flash_mod
    from attention_models_torch.ops import layernorm as ln_mod
    from attention_models_torch.ops.codebook import (
        _nearest_codes_reference, l2_normalize, nearest_codes)
    from attention_models_torch.data.loaders import build_loader
    from attention_models_torch.models.factory import build_model
    from attention_models_torch.models.vitvqgan import ViTVQGANBlock
    from attention_models_torch.ops.ffn import (
        _ln_mlp_backward_reference, _ln_mlp_reference, fused_ln_mlp,
        fused_ln_mlp_backward)
    from attention_models_torch.ops.flash_attention import (
        _flash_backward_reference, _flash_reference, flash_attention_bthd_kv,
        flash_attention_bwd_kv)
    from attention_models_torch.training.build_trainer import build_trainer
    from attention_models_torch.ops.layernorm import _ln_reference, layernorm
    from attention_models_torch.serving import (
        vq_encode_service, vq_recon_service)

    F = torch.nn.functional
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- 1 --
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {name} | sm_{''.join(map(str, torch.cuda.get_device_capability(0)))}"
          f" | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"nvidia-smi: {smi}", flush=True)

    # ---------------------------------------------------------------- 2 --
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s -> {lib_path.name}",
          flush=True)

    # ---------------------------------------------------------------- 3 --
    def time_ms(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def rel_l2(a, b):
        a, b = a.double(), b.double()
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))

    def max_abs(a, b):
        return float((a.float() - b.float()).abs().max())

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def bound(bytes_moved, flops, dtype):
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]] * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                     "operations")

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                + shift).to(dtype)

    variants = []

    def record(kernel, label, dtype, tol, err, abs_err, ms, plain_ms,
               lib_ms, bytes_moved, flops, metric="rel_l2"):
        b_ms, b_by = bound(bytes_moved, flops, dtype)
        v = dict(kernel=kernel, variant=label, dtype=str(dtype).split(".")[-1],
                 metric=metric, err=err, tol=tol, max_abs_err=abs_err, ms=ms,
                 plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                 bound_by=b_by)
        variants.append(v)
        print(f"[kernel] {kernel} {label}: {metric} {err:.3e} (tol {tol:g}) "
              f"max_abs {abs_err:.3e} | kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)
        if not err <= tol:
            raise AssertionError(f"{kernel} {label}: {metric} {err} > {tol}")
        return v

    n_tok, dim, patch_feat, hid = 8 * 1024, 512, 192, 1368

    # LayerNorm: the model-width rows (bf16 in the bf16 model, fp32 in the
    # fp32 one) and the patch-embed rows (fp32 images from the services)
    for d, dtype in ((dim, torch.bfloat16), (dim, torch.float32),
                     (patch_feat, torch.float32), (patch_feat, torch.bfloat16)):
        x = randn(n_tok, d, dtype=dtype, scale=2.0, shift=0.5)
        g, b = randn(d, scale=0.1, shift=1.0), randn(d, scale=0.1)
        got, want = layernorm(x, g, b), _ln_reference(x, g, b, 1e-5)
        gl, bl = g.to(dtype), b.to(dtype)
        record("layernorm", f"({n_tok},{d})", dtype,
               BF16_TOL if dtype == torch.bfloat16 else F32_TOL,
               rel_l2(got, want), max_abs(got, want),
               time_ms(lambda: layernorm(x, g, b)),
               time_ms(lambda: _ln_reference(x, g, b, 1e-5)),
               time_ms(lambda: F.layer_norm(x, (d,), gl, bl)),
               nbytes(x, x, g, b), 8 * x.numel())

    # fused LN + MLP, bf16 only (the fp32 model runs LN kernel + matmuls)
    x = randn(n_tok, dim, dtype=torch.bfloat16)
    lng, lnb = randn(dim, scale=0.1, shift=1.0), randn(dim, scale=0.1)
    w1 = randn(hid, dim, dtype=torch.bfloat16, scale=dim ** -0.5)
    b1 = randn(hid, dtype=torch.bfloat16, scale=0.1)
    w2 = randn(dim, hid, dtype=torch.bfloat16, scale=hid ** -0.5)
    b2 = randn(dim, dtype=torch.bfloat16, scale=0.1)
    mlp_args = (x, lng, lnb, w1, b1, w2, b2)
    got, want = fused_ln_mlp(*mlp_args), _ln_mlp_reference(*mlp_args, 1e-5)
    # the MLP part alone, out - x: a tighter look than the residual sum
    # (2e-2: out is rounded to bf16 at |x|'s scale before x is taken off)
    mlp_err = rel_l2(got.float() - x.float(), want.float() - x.float())
    print(f"[kernel] ln_mlp MLP part (out - x): rel_l2 {mlp_err:.3e} "
          f"(tol 2e-2)", flush=True)
    if not mlp_err <= 2e-2:
        raise AssertionError(f"ln_mlp MLP part: rel_l2 {mlp_err}")
    lng_b, lnb_b = lng.to(torch.bfloat16), lnb.to(torch.bfloat16)

    def ln_mlp_library():
        h = F.linear(F.layer_norm(x, (dim,), lng_b, lnb_b), w1, b1)
        return x + F.linear(F.gelu(h), w2, b2)

    record("ln_mlp", f"({n_tok},{dim}) hid {hid}", torch.bfloat16, BF16_TOL,
           rel_l2(got, want), max_abs(got, want),
           time_ms(lambda: fused_ln_mlp(*mlp_args)),
           time_ms(lambda: _ln_mlp_reference(*mlp_args, 1e-5)),
           time_ms(ln_mlp_library),
           nbytes(x, x, lng, lnb, w1, b1, w2, b2), 4 * n_tok * dim * hid)

    # flash attention on packed kv, both dtypes, plus causal at tq = tk
    b_, t_, h_, d_ = 8, 1024, 8, 64
    for dtype, causal in ((torch.bfloat16, False), (torch.float32, False),
                          (torch.bfloat16, True), (torch.float32, True)):
        q = randn(b_, t_, h_, d_, dtype=dtype)
        kv = randn(b_, t_, 2, h_, d_, dtype=dtype)
        out, lse = flash_attention_bthd_kv(q, kv, causal=causal)
        out_p, lse_p = _flash_reference(q, kv, d_ ** -0.5, causal)
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        lse_err = rel_l2(lse, lse_p)
        if not lse_err <= tol:
            raise AssertionError(f"flash lse rel_l2 {lse_err} > {tol}")
        qs = q.transpose(1, 2).contiguous()
        ks = kv[:, :, 0].transpose(1, 2).contiguous()
        vs = kv[:, :, 1].transpose(1, 2).contiguous()
        pairs = t_ * (t_ + 1) // 2 if causal else t_ * t_
        record("flash_attention_bthd_kv",
               f"b{b_} t{t_} h{h_} d{d_} causal={causal} (lse rel_l2 "
               f"{lse_err:.2e})", dtype, tol,
               rel_l2(out, out_p), max_abs(out, out_p),
               time_ms(lambda: flash_attention_bthd_kv(q, kv, causal=causal)),
               time_ms(lambda: _flash_reference(q, kv, d_ ** -0.5, causal)),
               time_ms(lambda: F.scaled_dot_product_attention(
                   qs, ks, vs, is_causal=causal)),
               nbytes(q, kv, out, lse), 4 * b_ * h_ * d_ * pairs)

    def plain_distances(z, codes):
        zf, cf = z.float(), codes.float()
        return torch.sum(cf * cf, dim=-1)[None, :] - 2.0 * (zf @ cf.T)

    def index_report(idx, idx_p, dist):
        top2 = dist.topk(2, dim=1, largest=False).values
        gap = top2[:, 1] - top2[:, 0]
        differ = idx.long() != idx_p.long()
        chosen = dist.gather(1, idx.long()[:, None])[:, 0]
        return (float((~differ).float().mean()),
                float(gap[differ].max()) if bool(differ.any()) else 0.0,
                float((chosen - top2[:, 0]).max()))

    # nearest codes: L2-normalised tokens and table, as the codebook feeds it
    for dtype in (torch.bfloat16, torch.float32):
        z = l2_normalize(randn(n_tok, 32)).to(dtype)
        codes = l2_normalize(randn(8192, 32)).to(dtype)
        idx, idx_p = nearest_codes(z, codes), _nearest_codes_reference(z, codes)
        dist = plain_distances(z, codes)
        agree, worst_gap, excess = index_report(idx, idx_p, dist)
        print(f"[kernel] nearest_codes {dtype}: agreement {agree:.6f}, "
              f"largest gap at a disagreement {worst_gap:.3e} (tol 1e-5), "
              f"chosen-distance excess {excess:.3e} (tol 1e-5)", flush=True)
        if not (worst_gap <= 1e-5 and excess <= 1e-5):
            raise AssertionError("nearest_codes index criterion failed")
        zf, cf = z.float(), codes.float()
        record("nearest_codes", f"z ({n_tok},32) codes (8192,32)", dtype,
               1e-5, excess, excess,
               time_ms(lambda: nearest_codes(z, codes)),
               time_ms(lambda: _nearest_codes_reference(z, codes)),
               time_ms(lambda: torch.cdist(zf, cf).argmin(dim=1)),
               nbytes(z, codes, idx), 2 * n_tok * 8192 * 32,
               metric="chosen-distance excess")

    # backward kernels, bf16 and fp32, causal and not, at the main path's
    # shapes; the library call is SDPA's forward + backward
    scale = d_ ** -0.5
    for dtype, causal in ((torch.bfloat16, False), (torch.float32, False),
                          (torch.bfloat16, True), (torch.float32, True)):
        q = randn(b_, t_, h_, d_, dtype=dtype)
        kv = randn(b_, t_, 2, h_, d_, dtype=dtype)
        out, lse = flash_attention_bthd_kv(q, kv, causal=causal)
        g = randn(b_, t_, h_, d_, dtype=dtype)
        dq, dkv = flash_attention_bwd_kv(q, kv, out, lse, g, scale=scale,
                                         causal=causal)
        dq_p, dkv_p = _flash_backward_reference(q, kv, out, lse, g, scale,
                                                causal)
        pairs = [(dq, dq_p), (dkv[:, :, 0], dkv_p[:, :, 0]),
                 (dkv[:, :, 1], dkv_p[:, :, 1])]
        errs = [rel_l2(a, b) for a, b in pairs]
        qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, kv[:, :, 0], kv[:, :, 1]))
        gs = g.transpose(1, 2).contiguous()

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
            return torch.autograd.grad(o, (qs, ks, vs), gs)

        n_pairs = t_ * (t_ + 1) // 2 if causal else t_ * t_
        record("flash_attention_bwd_kv",
               f"b{b_} t{t_} h{h_} d{d_} causal={causal} (dq, dk, dv rel_l2 "
               f"{errs[0]:.2e}, {errs[1]:.2e}, {errs[2]:.2e})", dtype,
               BWD_BF16_TOL if dtype == torch.bfloat16 else F32_TOL,
               max(errs), max(max_abs(a, b) for a, b in pairs),
               time_ms(lambda: flash_attention_bwd_kv(
                   q, kv, out, lse, g, scale=scale, causal=causal)),
               time_ms(lambda: _flash_backward_reference(
                   q, kv, out, lse, g, scale, causal)),
               time_ms(sdpa_fwd_bwd),
               nbytes(q, kv, out, lse, g, dq, dkv),
               10 * b_ * h_ * d_ * n_pairs)

    # fused LN + MLP backward, bf16; the library call is layer_norm ->
    # linear -> gelu -> linear forward + backward
    dy = randn(n_tok, dim, dtype=torch.bfloat16)
    bwd_args = (x, lng, lnb, w1, b1, w2, dy)
    got = fused_ln_mlp_backward(*bwd_args)
    want = _ln_mlp_backward_reference(*bwd_args, 1e-5)
    names = ("dx", "dlng", "dlnb", "dw1", "db1", "dw2", "db2")
    errs = {k: rel_l2(a, b) for k, a, b in zip(names, got, want)}
    lib_leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, lng_b, lnb_b, w1, b1, w2, b2)]

    def ln_mlp_library_fwd_bwd():
        xl, gl, bl, w1l, b1l, w2l, b2l = lib_leaves
        h = F.linear(F.layer_norm(xl, (dim,), gl, bl), w1l, b1l)
        y = xl + F.linear(F.gelu(h), w2l, b2l)
        return torch.autograd.grad(y, lib_leaves, dy)

    record("ln_mlp_bwd", f"({n_tok},{dim}) hid {hid} (" + ", ".join(
               f"{k} {v:.2e}" for k, v in errs.items()) + ")",
           torch.bfloat16, BWD_BF16_TOL, max(errs.values()),
           max(max_abs(a, b) for a, b in zip(got, want)),
           time_ms(lambda: fused_ln_mlp_backward(*bwd_args)),
           time_ms(lambda: _ln_mlp_backward_reference(*bwd_args, 1e-5)),
           time_ms(ln_mlp_library_fwd_bwd),
           nbytes(x, lng, lnb, w1, b1, w2, dy, *got), 10 * n_tok * dim * hid)

    # ---------------------------------------------------------- 4 and 5 --
    wrappers = {"flash_attention_bthd_kv": flash_attention_bthd_kv,
                "ln_mlp": fused_ln_mlp, "layernorm": layernorm,
                "nearest_codes": nearest_codes,
                "flash_attention_bwd_kv": flash_attention_bwd_kv,
                "ln_mlp_bwd": fused_ln_mlp_backward}
    fwd_names = ("flash_attention_bthd_kv", "ln_mlp", "layernorm",
                 "nearest_codes")
    per_forward = {"flash_attention_bthd_kv": 12, "ln_mlp": 12,
                   "layernorm": 16, "nearest_codes": 1,
                   "flash_attention_bwd_kv": 0, "ln_mlp_bwd": 0}
    per_encode = {"flash_attention_bthd_kv": 6, "ln_mlp": 6,
                  "layernorm": 9, "nearest_codes": 1,
                  "flash_attention_bwd_kv": 0, "ln_mlp_bwd": 0}

    def counts():
        return {k: w.launches for k, w in wrappers.items()}

    def expect_delta(before, want, what):
        now = counts()
        delta = {k: now[k] - before[k] for k in now}
        if delta != want:
            raise AssertionError(f"{what}: launches {delta}, expected {want}")
        return now

    # one full-width block, forward + backward, kernels against plain
    torch.manual_seed(0)
    blk = ViTVQGANBlock(dim, h_, d_, 2048).to(dev)
    xb = randn(8, 1024, dim, dtype=torch.bfloat16)
    gb = randn(8, 1024, dim, dtype=torch.bfloat16)
    blk_names = ["dx"] + [k for k, _ in blk.named_parameters()]

    def block_grads(kernels):
        for m in blk.modules():
            if hasattr(m, "kernels"):
                m.kernels = kernels
        xr = xb.clone().requires_grad_(True)
        return torch.autograd.grad(blk(xr), [xr, *blk.parameters()], gb)

    c = counts()
    grads_k = block_grads(True)
    expect_delta(c, {k: int(k != "nearest_codes") for k in wrappers},
                 "block forward + backward")
    grads_p = block_grads(False)
    blk_errs = {k: rel_l2(a, b) for k, a, b in zip(blk_names, grads_k,
                                                   grads_p)}
    worst = max(blk_errs, key=blk_errs.get)
    print(f"[block] ViTVQGANBlock b8 t1024 d{dim}, bf16 over fp32 params, "
          f"fwd+bwd kernels vs plain: dx rel_l2 {blk_errs['dx']:.3e}, worst "
          f"{worst} {blk_errs[worst]:.3e} (tol {MODEL_BF16_TOL:g}), "
          f"{len(blk_errs)} gradients", flush=True)
    if not all(e <= MODEL_BF16_TOL for e in blk_errs.values()):
        raise AssertionError(f"block gradients: {blk_errs}")
    del blk, grads_k, grads_p

    fn, (model, imgs0) = entry()
    rs = np.random.RandomState(0)
    requests = [rs.rand(8, 3, 256, 256).astype(np.float32) for _ in range(3)]
    recon, encode = vq_recon_service(model), vq_encode_service(model)

    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    c = counts()
    rec0, loss0 = fn(model, imgs0)
    c = expect_delta(c, per_forward, "entry forward")
    recs = []
    for r in requests:
        recs.append(recon(r, None))
        c = expect_delta(c, per_forward, "recon request")
    idx_main = encode(requests[0], None)
    c = expect_delta(c, per_encode, "encode request")
    torch.cuda.synchronize()
    serving_launches = counts()
    print(f"[main] launches over 1 entry forward + 3 recon + 1 encode "
          f"request(s): {serving_launches}", flush=True)
    for t in (rec0, loss0, *recs):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("non-finite output on the main path")
    if recs[0].shape != (8, 3, 256, 256) or idx_main.shape != (8, 1024):
        raise AssertionError(f"shapes {recs[0].shape}, {idx_main.shape}")

    # the same weights through the plain path on the card
    with torch.inference_mode():
        x0 = torch.as_tensor(requests[0], device=dev)
        z_k = model.pre_quant(model.encoder(x0))
        dec_k = model.decode_indices(idx_main)
        model.use_kernels(False)
        z_p = model.pre_quant(model.encoder(x0))
        dec_p = model.decode_indices(idx_main)
        rec_p = recon(requests[0], None)
        idx_p = encode(requests[0], None)
        model.use_kernels(True)
    z_err, dec_err = rel_l2(z_k, z_p), rel_l2(dec_k, dec_p)
    print(f"[main] kernel vs plain on the card (bf16): encoder z rel_l2 "
          f"{z_err:.3e}, decoder on identical indices rel_l2 {dec_err:.3e} "
          f"(tol {MODEL_BF16_TOL:g}); index agreement "
          f"{float((idx_main == idx_p).float().mean()):.4f}, whole recon "
          f"rel_l2 {rel_l2(recs[0], rec_p):.3e} (reported)", flush=True)
    if not (z_err <= MODEL_BF16_TOL and dec_err <= MODEL_BF16_TOL):
        raise AssertionError("bf16 model kernel path disagrees with plain")

    def imgs_per_s(iters=10):
        recon(requests[0], None)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(iters):
            recon(requests[i % 3], None)
        torch.cuda.synchronize()
        return 8 * iters / (time.perf_counter() - t)

    kern_ips = imgs_per_s()
    model.use_kernels(False)
    plain_ips = imgs_per_s()
    model.use_kernels(True)
    print(f"[main] recon throughput, batch 8, 256 px, bf16: kernels "
          f"{kern_ips:.2f} imgs/s, plain {plain_ips:.2f} imgs/s | {smi}",
          flush=True)

    # the wrappers launch the forward kernel directly when nothing needs a
    # gradient (dispatch.needs_grad); against their autograd Functions on
    # the same requests, 10 alternating pairs (ABBA order) in this process
    def function_always(on):
        for m in (ffn_mod, flash_mod, ln_mod):
            m.needs_grad = (lambda *t: True) if on else dispatch.needs_grad

    wrapper_ab = {"direct": [], "function": []}
    for i in range(10):
        for way in (("direct", "function"), ("function", "direct"))[i % 2]:
            function_always(way == "function")
            wrapper_ab[way].append(imgs_per_s())
    function_always(False)
    ab_med = {k: float(np.median(v)) for k, v in wrapper_ab.items()}
    ab_won = sum(a > b for a, b in zip(wrapper_ab["direct"],
                                       wrapper_ab["function"]))
    print(f"[main] recon imgs/s, direct launch vs autograd Function, 10 "
          f"pairs: median {ab_med['direct']:.2f} vs {ab_med['function']:.2f}"
          f" (direct {min(wrapper_ab['direct']):.2f}-"
          f"{max(wrapper_ab['direct']):.2f}, Function "
          f"{min(wrapper_ab['function']):.2f}-"
          f"{max(wrapper_ab['function']):.2f}); direct faster in {ab_won} of"
          f" 10 pairs", flush=True)
    profile_rows = profile(torch, lambda: [recon(r, None) for r in requests],
                           lambda: recon(requests[0], None),
                           "3 recon requests")

    # ---------------------------------------------------------------- 6 --
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off for the fp32 golden path")
    model32 = vitvqgan_base(img_size=256, dtype=torch.float32, device=dev)
    x32 = torch.as_tensor(requests[1], device=dev)
    golden_want = {"flash_attention_bthd_kv": 6, "ln_mlp": 0,
                   "layernorm": 15, "nearest_codes": 1,
                   "flash_attention_bwd_kv": 0, "ln_mlp_bwd": 0}
    with torch.inference_mode():
        c = counts()
        idx_k = model32.encode_imgs(x32).reshape(-1)
        expect_delta(c, golden_want, "fp32 encode")
        model32.use_kernels(False)
        z_p = model32.pre_quant(model32.encoder(x32))
        idx_p = model32.codebook.nearest(z_p).reshape(-1)
        table = l2_normalize(model32.codebook.embedding.weight.float())
        dist = plain_distances(l2_normalize(z_p.float()).reshape(-1, 32),
                               table)
    agree, worst_gap, _ = index_report(idx_k, idx_p, dist)
    print(f"[golden] fp32 encode_imgs, TF32 off: index agreement {agree:.6f}"
          f" (tol >= 0.999), largest plain top-2 gap at a disagreement "
          f"{worst_gap:.3e} (tol 1e-4)", flush=True)
    if not (agree >= 0.999 and worst_gap <= 1e-4):
        raise AssertionError("fp32 golden index criterion failed")
    del model, model32

    # ---------------------------------------------------------------- 7 --
    # the training path, as `python -m attention_models_torch.main` runs
    # it (PyTorch's TF32 defaults: cuDNN convolutions in TF32)
    torch.backends.cudnn.allow_tf32 = True
    cfg = training_config(os.path.abspath(os.path.join(
        "chiprun_out", "chip_smoke_train")))
    trainer = build_trainer(cfg, build_model(cfg), build_loader(cfg), dev)
    step_fn = trainer.train_step
    steps = []

    def traced_step(img):
        torch.cuda.synchronize()
        before = counts()
        g0 = [p.detach().clone() for p in trainer.g_params]
        d0 = [p.detach().clone() for p in trainer.d_params]
        t = time.perf_counter()
        m = step_fn(img)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        steps.append(dict(
            ms=ms, losses={k: float(v) for k, v in m.items()},
            launches={k: v - before[k] for k, v in counts().items()},
            g_changed=any(not torch.equal(a, p)
                          for a, p in zip(g0, trainer.g_params)),
            d_changed=any(not torch.equal(a, p)
                          for a, p in zip(d0, trainer.d_params))))
        return m

    trainer.train_step = traced_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    trainer.train()
    torch.cuda.synchronize()
    launches = counts()
    trainer.train_step = step_fn
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    k_acc = trainer.gradient_accumulation_steps
    for i, st in enumerate(steps):
        print(f"[train] micro-step {i}: {st['ms']:.2f} ms, G changed "
              f"{st['g_changed']}, D changed {st['d_changed']}, losses "
              + ", ".join(f"{k} {v:.4f}" for k, v in st["losses"].items()),
              flush=True)
        if st["launches"] != PER_MICRO_STEP:
            raise AssertionError(f"micro-step {i}: launches "
                                 f"{st['launches']}, expected "
                                 f"{PER_MICRO_STEP}")
        if not all(np.isfinite(v) for v in st["losses"].values()):
            raise AssertionError(f"micro-step {i}: non-finite loss")
        updates = (i + 1) % k_acc == 0
        if st["g_changed"] != updates or st["d_changed"] != updates:
            raise AssertionError(f"micro-step {i}: parameters changed "
                                 f"G {st['g_changed']} D {st['d_changed']},"
                                 f" expected {updates}")
    if len(steps) != 4 or trainer.g_opt.count != 2:
        raise AssertionError(f"{len(steps)} micro-steps, "
                             f"{trainer.g_opt.count} optimizer steps")
    # steady state: the second optimizer step's two micro-steps (step 0
    # builds the cuDNN plans, step 1 allocates the optimizers' state)
    step_ms = float(np.mean([st["ms"] for st in steps[2:]]))
    train_ips = trainer.batch_size / step_ms * 1e3
    print(f"[train] 4 micro-steps, 2 optimizer steps, launches {launches} "
          f"(per micro-step {PER_MICRO_STEP}); micro-step {step_ms:.2f} ms "
          f"(mean of steps 2-3; steps 0-1 {steps[0]['ms']:.2f}, "
          f"{steps[1]['ms']:.2f} ms), "
          f"{train_ips:.2f} imgs/s, peak memory {peak_gib:.3f} GiB | {smi}",
          flush=True)
    img = trainer.to_device(next(iter(trainer.train_dl))[0])
    train_profile = profile(torch, lambda: [step_fn(img) for _ in range(2)],
                            lambda: step_fn(img), "2 training micro-steps")

    # ---------------------------------------------------------------- 8 --
    sources = {
        "flash_attention_bthd_kv": ("flash_attention.cu",
                                    "attention_models_tpu/ops/flash_attention.py:217"),
        "ln_mlp": ("ln_mlp.cu", "attention_models_tpu/ops/ffn.py:542"),
        "layernorm": ("layernorm.cu", "attention_models_tpu/ops/layernorm.py:22"),
        "nearest_codes": ("codebook.cu", "attention_models_tpu/ops/codebook.py:33"),
        "flash_attention_bwd_kv": ("flash_attention_bwd.cu",
                                   "attention_models_tpu/ops/flash_attention.py:498"),
        "ln_mlp_bwd": ("ln_mlp_bwd.cu", "attention_models_tpu/ops/ffn.py:652"),
    }
    kernels = []
    for k, (src, replaces) in sources.items():
        v = next(v for v in variants if v["kernel"] == k
                 and v["dtype"] == "bfloat16")  # the main path's dtype/shape
        row = dict(
            name=k, route="cuda", source=f"attention_models_torch/csrc/{src}",
            replaces=replaces, launches=launches[k],
            max_abs_err=v["max_abs_err"], ms=v["ms"], plain_ms=v["plain_ms"],
            bound_ms=v["bound_ms"], bound_by=v["bound_by"],
            library_ms=v["library_ms"])
        if k in fwd_names:
            row["launches_serving"] = serving_launches[k]
            if serving_launches[k] == 0:
                raise AssertionError(f"{k} never launched on the serving path")
        kernels.append(row)
        if launches[k] == 0:
            raise AssertionError(f"{k} never launched on the training path")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=name, nvidia_smi=smi, variants=variants,
                           kernels=kernels, launches=launches,
                           serving_launches=serving_launches,
                           block_grad_rel_l2=blk_errs,
                           recon_imgs_per_s=kern_ips,
                           plain_recon_imgs_per_s=plain_ips,
                           recon_imgs_per_s_wrapper_ab=wrapper_ab,
                           golden_index_agreement=agree,
                           profile=profile_rows, train_steps=steps,
                           train_step_ms=step_ms, train_imgs_per_s=train_ips,
                           train_peak_gib=peak_gib,
                           train_profile=train_profile), f, indent=1)
    amt.sync()
    print(f"[nvidia-smi] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def profile(torch, run, warm, label):
    """Device time by kernel over ``run()`` (torch.profiler), after one
    ``warm()``, and the share of the traced window's wall time the card was
    busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    warm()
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return getattr(e, attr)
        return 0.0

    # device-side events only (kernels, copies): a CPU op's row repeats the
    # device time of the kernels it launched, and so does a user annotation
    # on the device timeline ("Optimizer.step#OptaxAdam.step"); the
    # profiler's own buffer requests are not work
    rows = sorted(((e.key, dev_us(e) / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0
                   and not getattr(e, "is_user_annotation", False)
                   and not e.key.startswith(("Optimizer.", "Activity Buffer"))),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"[profile] {label}: wall {wall_ms:.3f} ms (traced), "
          f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f} %)")
    for key, ms, count in rows[:20]:
        print(f"[profile]   {ms:9.3f} ms {100 * ms / busy:5.1f} % x{count:<4d}"
              f" {key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy,
                rows=[dict(key=k, ms=m, count=c) for k, m, c in rows])


if __name__ == "__main__":
    sys.exit(main())
