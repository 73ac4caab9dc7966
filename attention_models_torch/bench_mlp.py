"""A/B timings of the GELU-MLP forwards (kernels 7 and 2) on one card.

    python attention_models_torch/bench_mlp.py [turns] [--iters N]
        For kernel 7 at ViT's shape (4160 x 1024, hidden 2048) and kernel 2
        at the ViTVQGAN main path's (8192 x 512, hidden 1368) and the wide
        widths (d 768 hidden 2048, d 1024 hidden 2728), bf16: the shipped
        plan, then each tile width of the two products (BN 128 or 256 for
        g = gelu(x W1^T + b1), then for g W2^T) through plans built with
        that width, and, where the hidden width is not a multiple of 32,
        the shipped tile widths with g's and W2's rows only 16-byte aligned
        (W2 as it stands, g at the hidden width's pitch). Device time
        (launches queued behind a sleep), in turns: every variant once in
        order, then once in reverse, twice over. Every variant must give
        the shipped plan's bits. The PyTorch chain (linear, gelu, linear;
        kernel 2 with layer_norm in front and + x behind) is timed beside
        them. Then each kernel's device time in the shipped plan
        (torch.profiler, 20 calls).
    python attention_models_torch/bench_mlp.py variants
        Builds copies of csrc/ with csrc/gemm_sm90.cuh edited (VARIANTS:
        the GELU epilogue left out, a diagnostic whose bits differ; the
        slice loop waiting for each slice's products; BN 128 at one block
        an SM with a 6-stage ring), each into its own library under
        build/mlp_variants/, and prints each product's device time
        (torch.profiler, 20 calls) at ViT's and the main path's shapes.
    python attention_models_torch/bench_mlp.py paths [--root R]
        Prints one JSON line for the checkout at R (default: this one):
        recon imgs/s (entry()'s ViTVQGAN through vq_recon_service, batch
        8, 10 requests a reading) and ViT eval imgs/s (cfg/vit.yaml as R's
        chip_smoke.py builds it, batch 64, 10 forwards a reading), five
        readings each, as chip_smoke.py's phases 5 and 13 time them; the
        ViTVQGAN training micro-step on cfg/vitvqgan.yaml as R's
        chip_smoke.py builds it (phase 7: bf16 compute, batch 8, the same
        synthetic batch each step): host clock of six micro-steps after two
        warm-ups, and the card's busy time of two more (torch.profiler,
        device events only); and the host's enqueue time of one
        fused_ln_mlp call at the main path's shape on bf16 parameters (50
        calls queued behind a sleep on the card, 15 readings) and of one
        fused_mlp call at ViT's. To
        compare two commits, unpack the parent's (git archive) under
        build/ and run this file with --root at it and at this checkout in
        turns (parent, change, change, parent) in one call; run it as a
        file, so the package is imported from R.

Needs a Hopper card and nvcc; the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import itertools
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# (label, n, d, hid, kernel 2?)
SHAPES = (("vit 7", 4160, 1024, 2048, False),
          ("main 2", 8192, 512, 1368, True),
          ("wide 2 d768", 8192, 768, 2048, True),
          ("wide 2 d1024", 8192, 1024, 2728, True))
WIDTHS = (128, 256)
# name: (edits of csrc/gemm_sm90.cuh, ring depth of BN 128 and of BN 256)
VARIANTS = {
    "shipped": ([], 3, 4),
    "no GELU (diagnostic)": (
        [("return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));",
          "return v;")], 3, 4),
    "wgmma_wait<0> a slice": (
        [("wgmma_wait<1>();  // the previous",
          "wgmma_wait<0>();  // the previous")],
        3, 4),
    "BN 128 one block an SM, 6 stages": (
        [("kStages = 3, kBlocksPerSM = 2", "kStages = 6, kBlocksPerSM = 1")],
        6, 4),
}


def _card() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} | {smi}", flush=True)


def _device_ms(fn, iters: int) -> float:
    """CUDA events around ``iters`` calls queued behind a sleep on the card
    (no gap where the card waits for the host)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6 + 2e6 * iters))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _profile(fn) -> dict:
    """Mean device time of each kernel of ``fn`` over 20 calls, in us."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = (getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA and t > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            out[name.split("(")[0][-40:]] = t / e.count
    return out


def _launch_split(fn, calls: int = 20) -> dict:
    """Each kernel of ``fn``: its device time a call (us) and its launches
    a call, over ``calls`` calls (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = (getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA and t > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0][-60:]
            us, n = out.get(name, (0.0, 0.0))
            out[name] = (us + t / calls, n + e.count / calls)
    return out


def run(iters: int) -> None:
    sys.path.insert(0, str(ROOT))
    from attention_models_torch.ops import _build, ffn
    from attention_models_torch.ops.gemm_sm90 import (
        K_MAJOR, gemm_plan, meta, scratch_meta)

    F = torch.nn.functional
    _card()
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, n, d, hid, ln in SHAPES:
        def randn(*shape, scale=1.0, shift=0.0, dtype=torch.bfloat16):
            return (torch.randn(*shape, generator=gen, device="cuda") * scale
                    + shift).to(dtype)

        x = randn(n, d)
        w1 = randn(hid, d, scale=d ** -0.5)
        w2 = randn(d, hid, scale=hid ** -0.5)
        b1 = randn(hid, scale=0.1, dtype=torch.float32)
        b2 = randn(d, scale=0.1, dtype=torch.float32)
        lng = randn(d, scale=0.1, shift=1.0, dtype=torch.float32)
        lnb = randn(d, scale=0.1, dtype=torch.float32)
        y = torch.empty_like(x)
        metas = (meta("x", x), meta("w1", w1), meta("w2", w2))
        stream = _build.stream_of(x)
        shipped = ffn.mlp_plan(x, w1, w2)

        def launch(plan):
            """A kernel variant: (its call, the output it writes); W2 staged
            by the C side where the plan's pitch differs from hid."""
            out = torch.empty_like(x)
            g = torch.empty(n, plan.up.ldc, dtype=x.dtype, device="cuda")
            nw = plan.w2_stage_elems(hid)
            stage = (torch.empty(nw, dtype=x.dtype, device="cuda").data_ptr()
                     if nw else None)
            if ln:
                def call():
                    _build.launch(
                        "amt_ln_mlp", x.data_ptr(), lng.data_ptr(),
                        lnb.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                        w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                        y.data_ptr(), g.data_ptr(), stage, plan.c_array(), n,
                        d, hid, 1e-5, 0, stream)
            else:
                def call():
                    _build.launch(
                        "amt_mlp", x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                        w2.data_ptr(), b2.data_ptr(), None, g.data_ptr(),
                        stage, out.data_ptr(), plan.c_array(), n, d, hid, 0,
                        stream)
            return call, out

        # name: (call, output or None (the call returns it), same bits
        # as the first required)
        first = f"shipped (BN {shipped.up.bn}/{shipped.down.bn})"
        variants = {first: (*launch(shipped), True)}
        gm = ffn._g_meta(n, hid)
        for up, down in itertools.product(WIDTHS, WIDTHS):
            plan = ffn.MlpPlan(
                gemm_plan(metas[0], K_MAJOR, metas[1], K_MAJOR, up, gm[2][0]),
                gemm_plan(gm, K_MAJOR, ffn._w2_meta(metas[2]), K_MAJOR, down,
                          d))
            variants[f"BN {up}/{down}"] = (*launch(plan), True)
        if hid % ffn.ROW_ALIGN:
            g16 = scratch_meta("g", n, hid, hid)
            plan = ffn.MlpPlan(
                dataclasses.replace(shipped.up, ldc=hid),
                gemm_plan(g16, K_MAJOR, metas[2], K_MAJOR, shipped.down.bn,
                          d))
            variants["rows 16-byte aligned"] = (*launch(plan), True)
        lng_b, lnb_b = lng.bfloat16(), lnb.bfloat16()
        b1_b, b2_b = b1.bfloat16(), b2.bfloat16()
        if ln:
            chain = lambda: x + F.linear(F.gelu(F.linear(  # noqa: E731
                F.layer_norm(x, (d,), lng_b, lnb_b), w1, b1_b)), w2, b2_b)
        else:
            chain = lambda: F.linear(F.gelu(F.linear(  # noqa: E731
                x, w1, b1_b)), w2, b2_b)
        variants["library"] = (chain, None, False)

        def output(name):
            call, out, _ = variants[name]
            res = call()
            torch.cuda.synchronize()
            return res if out is None else out.clone()

        ref_out = output(first)
        times = {name: [] for name in variants}
        order = list(variants)
        for seq in (order, order[::-1], order, order[::-1]):
            for name in seq:
                times[name].append(_device_ms(variants[name][0], iters))
        for name, (_, _, exact) in variants.items():
            got = output(name)
            diff = float((got.float() - ref_out.float()).norm()
                         / ref_out.float().norm())
            if exact and not torch.equal(got, ref_out):
                raise AssertionError(f"{label} {name}: bits differ from "
                                     f"{first} (rel {diff:.3e})")
            ms = sorted(times[name])
            row = dict(shape=label, n=n, d=d, hid=hid, variant=name,
                       ms=times[name], median_ms=(ms[1] + ms[2]) / 2,
                       rel_to_first=diff)
            rows.append(row)
            print(f"[mlp] {label} n{n} d{d} hid{hid} {name}: "
                  + " / ".join(f"{t:.4f}" for t in times[name])
                  + f" ms (median {row['median_ms']:.4f}); rel to {first} "
                  f"{diff:.2e}", flush=True)
        per_kernel = _profile(variants[first][0])
        rows.append(dict(shape=label, n=n, d=d, hid=hid, variant=first,
                         per_kernel_us=per_kernel))
        print(f"[mlp] {label} {first} per kernel (us): {per_kernel}",
              flush=True)
    print(json.dumps({"rows": rows}))


def variants() -> None:
    sys.path.insert(0, str(ROOT))
    from attention_models_torch.ops import _build, ffn
    from attention_models_torch.ops.gemm_sm90 import GEMM_K, GEMM_ROWS

    _card()
    csrc = ROOT / "attention_models_torch" / "csrc"
    out = ROOT / "build" / "mlp_variants"
    procs = {}
    for i, (name, (edits, _, _)) in enumerate(VARIANTS.items()):
        d = out / f"v{i}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        text = (d / "gemm_sm90.cuh").read_text()
        for old, new in edits:
            if old not in text:
                raise ValueError(f"csrc/gemm_sm90.cuh has no {old!r}")
            text = text.replace(old, new)
        (d / "gemm_sm90.cuh").write_text(text)
        cmd = [_build.nvcc_path(), *_build.ARCH, *_build.FLAGS, "-shared",
               *(str(d / f) for f in ("mlp.cu", "ln_mlp.cu", "layernorm.cu",
                                      "errors.cu")), "-o", str(d / "lib.so")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for fn in ("amt_mlp", "amt_ln_mlp"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for label, n, d, hid, ln in SHAPES[:2]:
        x = torch.randn(n, d, generator=gen, device="cuda").bfloat16()
        w1 = (torch.randn(hid, d, generator=gen, device="cuda")
              * d ** -0.5).bfloat16()
        w2 = (torch.randn(d, hid, generator=gen, device="cuda")
              * hid ** -0.5).bfloat16()
        b1, b2 = torch.zeros(hid, device="cuda"), torch.zeros(d, device="cuda")
        lng, lnb = torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")
        y, res = torch.empty_like(x), torch.empty_like(x)
        shipped = ffn.mlp_plan(y if ln else x, w1, w2)
        g = torch.empty(n, shipped.up.ldc, dtype=x.dtype, device="cuda")
        nw = shipped.w2_stage_elems(hid)
        stage = (torch.empty(nw, dtype=x.dtype, device="cuda").data_ptr()
                 if nw else None)
        for name, lib in libs.items():
            _, st128, st256 = VARIANTS[name]
            plan = ffn.MlpPlan(*(dataclasses.replace(
                p, smem=(st128 if p.bn == 128 else st256)
                * (GEMM_ROWS + p.bn) * GEMM_K * 2
                + 16 * (st128 if p.bn == 128 else st256) + 1024)
                for p in (shipped.up, shipped.down)))

            def call(lib=lib, arr=plan.c_array()):
                if ln:
                    err = lib.amt_ln_mlp(
                        x.data_ptr(), lng.data_ptr(), lnb.data_ptr(),
                        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                        b2.data_ptr(), res.data_ptr(), y.data_ptr(),
                        g.data_ptr(), stage, arr, n, d, hid, 1e-5, 0, stream)
                else:
                    err = lib.amt_mlp(
                        x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                        w2.data_ptr(), b2.data_ptr(), None, g.data_ptr(),
                        stage, res.data_ptr(), arr, n, d, hid, 0, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            per_kernel = _profile(call)
            print(f"[variant] {label} n{n} d{d} hid{hid} {name}: "
                  + ", ".join(f"{k} {v:.2f} us" for k, v in
                              per_kernel.items()), flush=True)


def paths(root: Path) -> None:
    os.chdir(root)
    sys.path.insert(0, str(root))
    import numpy as np

    from attention_models_torch.entry import entry
    from attention_models_torch.models.factory import build_model
    from attention_models_torch.serving import vq_recon_service

    _card()
    import chip_smoke as cs  # the ViT configuration, as it builds it

    from attention_models_torch.ops.ffn import fused_ln_mlp, fused_mlp

    res = dict(root=str(root), recon_imgs_per_s=[], vit_eval_imgs_per_s=[])
    gen = torch.Generator(device="cuda").manual_seed(0)

    def bf16(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).bfloat16()

    for name, n, d, hid, call in (
            ("ln_mlp", 8192, 512, 1368, lambda a: fused_ln_mlp(*a)),
            ("mlp", 4160, 1024, 2048, lambda a: fused_mlp(a[0], *a[3:]))):
        args = (bf16(n, d), bf16(d, scale=0.1) + 1, bf16(d, scale=0.1),
                bf16(hid, d, scale=d ** -0.5), bf16(hid, scale=0.1),
                bf16(d, hid, scale=hid ** -0.5), bf16(d, scale=0.1))
        us = []
        with torch.inference_mode():
            for _ in range(20):
                call(args)
            torch.cuda.synchronize()
            for _ in range(15):
                torch.cuda._sleep(int(60e6))  # the calls only enqueue
                t = time.perf_counter()
                for _ in range(50):
                    call(args)
                us.append((time.perf_counter() - t) / 50 * 1e6)
                torch.cuda.synchronize()
        res[f"{name}_enqueue_us"] = us
    _, (model, _) = entry()
    recon = vq_recon_service(model)
    rs = np.random.RandomState(0)
    requests = [rs.rand(8, 3, 256, 256).astype(np.float32) for _ in range(3)]
    vit = build_model(cs.vit_config(None, str(root / "build" / "bench_vit")),
                      device=torch.device("cuda")).eval()
    vimg = torch.rand(64, 3, 256, 256, device="cuda")
    for _ in range(5):
        recon(requests[0], None)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(10):
            recon(requests[i % 3], None)
        torch.cuda.synchronize()
        res["recon_imgs_per_s"].append(80 / (time.perf_counter() - t))
        with torch.no_grad():
            vit(vimg)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(10):
                vit(vimg)
            torch.cuda.synchronize()
        res["vit_eval_imgs_per_s"].append(640 / (time.perf_counter() - t))
    del model, recon, vit
    res.update(_train_paths(cs, root))
    print(json.dumps(res), flush=True)


def _train_paths(cs, root: Path) -> dict:
    """The ViTVQGAN training micro-step of the checkout at ``root``: host
    ms of six steps after two warm-ups, and the card's busy ms a step over
    two traced steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from attention_models_torch.data.loaders import build_loader
    from attention_models_torch.models.factory import build_model
    from attention_models_torch.training.build_trainer import build_trainer

    torch.backends.cudnn.allow_tf32 = True  # as phase 7 (main.py's default)
    cfg = cs.training_config(str(root / "build" / "bench_train"))
    loaders = build_loader(cfg)  # (train, validation)
    trainer = build_trainer(cfg, build_model(cfg), loaders,
                            torch.device("cuda"))
    img = trainer.to_device(next(iter(loaders[0]))[0])
    for _ in range(2):
        trainer.train_step(img)
    torch.cuda.synchronize()
    ms = []
    for _ in range(6):
        t = time.perf_counter()
        trainer.train_step(img)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            trainer.train_step(img)
        torch.cuda.synchronize()
    busy = sum(getattr(e, "self_device_time_total", 0)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith(("Optimizer.", "Activity Buffer")))
    return dict(train_step_ms=ms, train_device_ms_a_step=busy / 2e3)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="turns",
                    choices=("turns", "variants", "paths"))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--root", type=Path, default=ROOT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_mlp: CUDA is not available", file=sys.stderr)
        return 2
    if args.mode == "variants":
        variants()
    elif args.mode == "paths":
        paths(args.root.resolve())
    else:
        run(args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
