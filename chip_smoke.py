"""Chip smoke test of the PyTorch/CUDA port (attention_models_torch).

    python3 chip_smoke.py [--out results.json]

Needs one Hopper card. Phases, one line each (any failure raises):
  1. device   the card's name, nvidia-smi's name and power limit
  2. build    nvcc of attention_models_torch/csrc/*.cu (one process a file)
  3. kernels  each kernel at the main path's shapes against its plain
              version on the card, in each dtype it takes, with kernel,
              plain and library (one PyTorch call) times and the bound
  4. main     the main path: entry() (ViTVQGAN 256 px, bf16, batch 8,
              seeded weights), 3 requests through vq_recon_service and 1
              through vq_encode_service; every kernel's launch count must
              rise by its per-forward count; the same weights through the
              plain path on the card; recon imgs/s; device time by kernel
              over 3 traced recon requests (torch.profiler)
  5. golden   fp32 encode_imgs, kernels against plain, TF32 off
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
    disagreement lies at a plain top-2 distance gap <= 1e-4.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # fp32 outside the tensor cores
BF16_TOL, F32_TOL, MODEL_BF16_TOL = 1e-2, 1e-5, 2e-2


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
    from attention_models_torch.ops import _build
    from attention_models_torch.ops.codebook import (
        _nearest_codes_reference, l2_normalize, nearest_codes)
    from attention_models_torch.ops.ffn import _ln_mlp_reference, fused_ln_mlp
    from attention_models_torch.ops.flash_attention import (
        _flash_reference, flash_attention_bthd_kv)
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

    # ---------------------------------------------------------------- 4 --
    wrappers = {"flash_attention_bthd_kv": flash_attention_bthd_kv,
                "ln_mlp": fused_ln_mlp, "layernorm": layernorm,
                "nearest_codes": nearest_codes}
    per_forward = {"flash_attention_bthd_kv": 12, "ln_mlp": 12,
                   "layernorm": 16, "nearest_codes": 1}
    per_encode = {"flash_attention_bthd_kv": 6, "ln_mlp": 6,
                  "layernorm": 9, "nearest_codes": 1}

    def counts():
        return {k: w.launches for k, w in wrappers.items()}

    def expect_delta(before, want, what):
        now = counts()
        delta = {k: now[k] - before[k] for k in now}
        if delta != want:
            raise AssertionError(f"{what}: launches {delta}, expected {want}")
        return now

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
    launches = counts()
    print(f"[main] launches over 1 entry forward + 3 recon + 1 encode "
          f"request(s): {launches}", flush=True)
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
    profile_rows = profile_recon(torch, recon, requests)

    # ---------------------------------------------------------------- 5 --
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off for the fp32 golden path")
    model32 = vitvqgan_base(img_size=256, dtype=torch.float32, device=dev)
    x32 = torch.as_tensor(requests[1], device=dev)
    golden_want = {"flash_attention_bthd_kv": 6, "ln_mlp": 0,
                   "layernorm": 15, "nearest_codes": 1}
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

    # ---------------------------------------------------------------- 6 --
    sources = {
        "flash_attention_bthd_kv": ("flash_attention.cu",
                                    "attention_models_tpu/ops/flash_attention.py:217"),
        "ln_mlp": ("ln_mlp.cu", "attention_models_tpu/ops/ffn.py:542"),
        "layernorm": ("layernorm.cu", "attention_models_tpu/ops/layernorm.py:22"),
        "nearest_codes": ("codebook.cu", "attention_models_tpu/ops/codebook.py:33"),
    }
    kernels = []
    for k, (src, replaces) in sources.items():
        v = next(v for v in variants if v["kernel"] == k
                 and v["dtype"] == "bfloat16")  # the main path's dtype/shape
        kernels.append(dict(
            name=k, route="cuda", source=f"attention_models_torch/csrc/{src}",
            replaces=replaces, launches=launches[k],
            max_abs_err=v["max_abs_err"], ms=v["ms"], plain_ms=v["plain_ms"],
            bound_ms=v["bound_ms"], bound_by=v["bound_by"],
            library_ms=v["library_ms"]))
        if launches[k] == 0:
            raise AssertionError(f"{k} never launched on the main path")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=name, nvidia_smi=smi, variants=variants,
                           kernels=kernels, launches=launches,
                           recon_imgs_per_s=kern_ips,
                           plain_recon_imgs_per_s=plain_ips,
                           golden_index_agreement=agree,
                           profile=profile_rows), f, indent=1)
    amt.sync()
    print(f"[nvidia-smi] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def profile_recon(torch, recon, requests):
    """Device time by kernel over 3 recon requests (torch.profiler), and the
    share of the traced window's wall time the card was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    recon(requests[0], None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for r in requests:
            recon(r, None)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return getattr(e, attr)
        return 0.0

    # device-side events only (kernels, copies): a CPU op's row repeats the
    # device time of the kernels it launched; the profiler's own buffer
    # requests are not work
    rows = sorted(((e.key, dev_us(e) / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0
                   and not e.key.startswith("Activity Buffer")),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"[profile] 3 recon requests: wall {wall_ms:.3f} ms (traced), "
          f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f} %)")
    for key, ms, count in rows[:15]:
        print(f"[profile]   {ms:9.3f} ms {100 * ms / busy:5.1f} % x{count:<4d}"
              f" {key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy,
                rows=[dict(key=k, ms=m, count=c) for k, m, c in rows])


if __name__ == "__main__":
    sys.exit(main())
