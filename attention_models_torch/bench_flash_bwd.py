"""A/B timings of the flash backward (and the fp32 forward) on one card,
beside chip_smoke.py's.

    python attention_models_torch/bench_flash_bwd.py variants [--source F]
        Builds copies of csrc/flash_attention_bwd.cu with the bf16 kernels'
        ring depths and blocks an SM edited (and, with --source, the file F
        as one more variant, such as a parent commit's copy), each into its
        own library under build/flash_bwd_variants/, and times their dkv
        and dq kernels in turns at the main paths' shapes (device time,
        launches queued behind a sleep). Every variant must give the first
        one's bits.
    python attention_models_torch/bench_flash_bwd.py fwd32
        Builds copies of csrc/flash_attention.cu with the fp32 forward's
        ring depth and blocks an SM edited, each into its own library under
        build/flash_fwd32_variants/, and times the fp32 forward (kernel 16's
        layout) in turns at the recon shape (h 8 and 12) and at t 4096
        (causal and not). Every variant must give the first one's bits.
    python attention_models_torch/bench_flash_bwd.py bits --root R
        Builds the kernels' library of the checkout at R beside this one's
        and runs the flash kernels of both on the same inputs: the bf16
        forward and the fp32 backward (dkv, dq) must give R's bits; the
        fp32 forward's relative L2 to R's is printed.
    python attention_models_torch/bench_flash_bwd.py paths [--root R]
        Prints one JSON line for the checkout at R (default: this one):
        longcontext()'s rows, the 4-shard ring's forward + backward at
        t 16384, and micro-steps of the MaskGIT trainer on cfg/maskgit.yaml
        (bf16, then the shipped fp32), as R's chip_smoke.py builds it. To
        compare two commits, unpack the parent's (git archive) under build/
        and run this file with --root at it and at this checkout in turns
        (parent, change, change, parent) in one call; run as a file, so the
        package is imported from R.

Needs a Hopper card and nvcc; the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "attention_models_torch" / "csrc"
SHAPES = (("recon 5", 8, 8, 1024, False), ("recon 5 h12", 8, 12, 1024, False),
          ("t4096 causal", 1, 8, 4096, True), ("t4096", 1, 8, 4096, False),
          ("t16384 causal", 1, 8, 16384, True))
# name: (dkv stages, dkv blocks an SM, dq stages, dq blocks an SM)
VARIANTS = {"dkv 3/2 dq 2/4": (3, 2, 2, 4), "dkv 2/3 dq 2/4": (2, 3, 2, 4),
            "dkv 3/2 dq 3/3": (3, 2, 3, 3)}
# the fp32 forward's (stages, blocks an SM) variants; the first is shipped
FWD32_VARIANTS = {"2 stages, 3 blocks": (2, 3), "3 stages, 2 blocks": (3, 2),
                  "2 stages, 2 blocks": (2, 2)}
FWD32_SHAPES = (("recon h8", 8, 8, 1024, False),
                ("recon h12", 8, 12, 1024, False),
                ("t4096 causal", 1, 8, 4096, True),
                ("t4096", 1, 8, 4096, False))
HEADERS = ("common.cuh", "hopper.cuh", "flash_f32.cuh", "errors.cu")


def _card() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} | {smi}", flush=True)


def _edited(text: str, dkv_st: int, dkv_b: int, dq_st: int, dq_b: int):
    """The backward source with the given ring depths and blocks an SM."""
    subs = [("constexpr int kDkvStages = 3;",
             f"constexpr int kDkvStages = {dkv_st};"),
            ("constexpr int kDqStages = 2;",
             f"constexpr int kDqStages = {dq_st};"),
            ("__launch_bounds__(kBwdThreads, 2) void flash_bwd_dkv_bf16",
             f"__launch_bounds__(kBwdThreads, {dkv_b}) void flash_bwd_dkv_bf16"),
            ("__launch_bounds__(kBwdThreads, 4) void flash_bwd_dq_bf16",
             f"__launch_bounds__(kBwdThreads, {dq_b}) void flash_bwd_dq_bf16")]
    for old, new in subs:
        if old not in text:
            raise ValueError(f"the backward source has no {old!r}")
        text = text.replace(old, new)
    return text


def _smem(d: int, dkv_st: int, dq_st: int) -> tuple[int, int]:
    """ops/flash_attention.py's bwd_smem_bytes at other ring depths."""
    tile = 64 * d * 2
    return ((2 + 3 * dkv_st) * tile + 1024 + 8 * (1 + dkv_st) + 1024,
            (2 + 2 * dq_st) * tile + 8 * (1 + 2 * dq_st) + 1024)


def variants(source: str | None) -> None:
    sys.path.insert(0, str(ROOT))
    from attention_models_torch.ops import flash_attention as fa

    _card()
    base = (CSRC / "flash_attention_bwd.cu").read_text()
    cases = {n: (_edited(base, *v), v[0], v[2]) for n, v in VARIANTS.items()}
    if source:  # its ring depths as the file states them
        text = Path(source).read_text()
        st = [int(text.split(f"constexpr int {k} = ")[1].split(";")[0])
              for k in ("kDkvStages", "kDqStages")]
        cases[f"source {source}"] = (text, *st)
    libs = _build_variants(
        "flash_bwd_variants", "flash_attention_bwd.cu",
        {n: c[0] for n, c in cases.items()},
        ("amt_flash_bwd_dkv", "amt_flash_bwd_dq"))

    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    names = list(cases)
    for label, b, h, t, causal in SHAPES:
        q, k, v, g = (torch.randn(b, h, t, 64, generator=gen, device="cuda")
                      .bfloat16() for _ in range(4))
        o, lse = fa.flash_forward(q, k, v, scale=0.125, causal=causal)
        delta = fa.flash_delta(o, g)
        plan = list(fa.bwd_plan(q, k, v, g, causal).c_array())
        strides = fa._strides(q, k, v, g, lse, delta, q, k, v)
        ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
               lse.data_ptr(), delta.data_ptr())
        tail = (b, h, t, t, 64, 0.125, int(causal), 1, stream)
        for which in ("dkv", "dq"):
            outs, runs = {}, {}
            for name in names:
                plan[42:44] = _smem(64, *cases[name][1:])
                arr = (ctypes.c_int64 * 45)(*plan)
                res = [torch.empty_like(x) for x in (q, k, v)]
                outs[name] = res[1:] if which == "dkv" else res[:1]
                lib = libs[name]

                def run(lib=lib, arr=arr, res=res):
                    if which == "dkv":
                        err = lib.amt_flash_bwd_dkv(
                            *ins, res[1].data_ptr(), res[2].data_ptr(),
                            strides, arr, *tail)
                    else:
                        err = lib.amt_flash_bwd_dq(*ins, res[0].data_ptr(),
                                                   strides, arr, *tail)
                    if err:
                        raise RuntimeError(f"launch: CUDA error {err}")
                runs[name] = run
            times = {n: [] for n in names}
            for rnd in range(4):
                for n in (names if rnd % 2 == 0 else names[::-1]):
                    times[n].append(_device_ms(runs[n]))
            same = all(torch.equal(a, r) for n in names
                       for a, r in zip(outs[n], outs[names[0]]))
            if not same:
                raise AssertionError(f"{label} {which}: variants differ")
            print(f"[{label}] {which}: " + ", ".join(
                f"{n} {sum(x) / len(x):.4f} ms ("
                + " / ".join(f"{y:.4f}" for y in x) + ")"
                for n, x in times.items()) + "; same bits", flush=True)


def _build_variants(out: str, source: str, texts: dict,
                    fns: tuple) -> dict:
    """Each text as csrc/``source`` beside the headers it includes, built
    into build/``out``/v<i>/lib.so by one nvcc each, all started together;
    prints ptxas's registers and spills and returns the libraries with the
    entries ``fns`` bound, by name."""
    from attention_models_torch.ops import _build
    procs, libs = {}, {}
    for i, (name, text) in enumerate(texts.items()):
        d = ROOT / "build" / out / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        for f in HEADERS:
            shutil.copy(CSRC / f, d)
        (d / source).write_text(text)
        cmd = [_build.nvcc_path(), *_build.ARCH, *_build.FLAGS, "-shared",
               str(d / source), str(d / "errors.cu"), "-o", str(d / "lib.so")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [int(x.split()[0]) for x in log.split("Used")[1:]]
        spills = log.count(" 0 bytes spill stores")
        print(f"[build] {name}: registers {regs}, kernels without spills "
              f"{spills} of {len(regs)}", flush=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        for fn in fns:
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def fwd32() -> None:
    sys.path.insert(0, str(ROOT))
    from attention_models_torch.ops import flash_attention as fa

    _card()
    base = (CSRC / "flash_attention.cu").read_text()
    texts = {}
    for name, (stages, blocks) in FWD32_VARIANTS.items():
        text = base
        for old, new in (("constexpr int kFwd32Stages = 2;",
                          f"constexpr int kFwd32Stages = {stages};"),
                         ("constexpr int kFwd32Blocks = 3;",
                          f"constexpr int kFwd32Blocks = {blocks};")):
            if old not in text:
                raise ValueError(f"the forward source has no {old!r}")
            text = text.replace(old, new)
        texts[name] = text
    libs = _build_variants("flash_fwd32_variants", "flash_attention.cu",
                           texts, ("amt_flash_fwd",))
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    names = list(libs)
    for label, b, h, t, causal in FWD32_SHAPES:
        q, k, v = (torch.randn(b, h, t, 64, generator=gen, device="cuda")
                   for _ in range(3))
        outs, runs = {}, {}
        for name in names:
            o = torch.empty_like(q)
            lse = torch.empty(b, h, t, device="cuda")
            outs[name] = (o, lse)
            strides = fa._strides(q, k, v, o, lse)

            def run(lib=libs[name], o=o, lse=lse, strides=strides):
                err = lib.amt_flash_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), strides, None, b, h, t, t, 64, 0.125,
                    int(causal), 0, stream)
                if err:
                    raise RuntimeError(f"launch: CUDA error {err}")
            runs[name] = run
        times = {n: [] for n in names}
        for rnd in range(4):
            for n in (names if rnd % 2 == 0 else names[::-1]):
                times[n].append(_device_ms(runs[n]))
        same = all(torch.equal(a, r) for n in names
                   for a, r in zip(outs[n], outs[names[0]]))
        if not same:
            raise AssertionError(f"{label}: variants differ")
        print(f"[{label}] fp32 forward: " + ", ".join(
            f"{n} {sum(x) / len(x):.4f} ms ("
            + " / ".join(f"{y:.4f}" for y in x) + ")"
            for n, x in times.items()) + "; same bits", flush=True)


def bits(root: Path) -> None:
    sys.path.insert(0, str(ROOT))
    from attention_models_torch.ops import _build
    from attention_models_torch.ops import flash_attention as fa

    _card()
    other = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.'); from "
         "attention_models_torch.ops import _build; print(_build.build())"],
        cwd=root, capture_output=True, text=True, check=True)
    libs = {"this": ctypes.CDLL(str(_build.build())),
            "root": ctypes.CDLL(other.stdout.strip().splitlines()[-1])}
    for lib in libs.values():
        for fn in ("amt_flash_fwd", "amt_flash_bwd_dkv", "amt_flash_bwd_dq"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def run(lib, q, k, v, g, causal, fwd_from=None):
        """The forward (or R's, given ``fwd_from``), then dkv and dq."""
        b, h, t, d = q.shape
        dtype = q.dtype
        bf16 = dtype == torch.bfloat16
        tail = (b, h, t, t, d, 0.125, int(causal), _build.DTYPE_CODES[dtype],
                stream)
        o, lse = torch.empty_like(q), torch.empty(b, h, t, device="cuda")
        flib = lib if fwd_from is None else fwd_from
        err = flib.amt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), fa._strides(q, k, v, o, lse),
            fa.fwd_plan(q, k, v, causal).c_array() if bf16 else None, *tail)
        delta = fa.flash_delta(o, g)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        st = fa._strides(q, k, v, g, lse, delta, dq, dk, dv)
        plan = fa.bwd_plan(q, k, v, g, causal).c_array() if bf16 else None
        ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
               lse.data_ptr(), delta.data_ptr())
        err = err or lib.amt_flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(),
                                           st, plan, *tail)
        err = err or lib.amt_flash_bwd_dq(*ins, dq.data_ptr(), st, plan, *tail)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return o, lse, dq, dk, dv

    for label, b, h, t, causal in SHAPES[:3]:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, g = (torch.randn(b, h, t, 64, generator=gen,
                                      device="cuda").to(dtype)
                          for _ in range(4))
            this = run(libs["this"], q, k, v, g, causal)
            ref = run(libs["root"], q, k, v, g, causal)
            err_o = float((this[0].double() - ref[0].double()).norm()
                          / ref[0].double().norm())
            if dtype == torch.bfloat16:  # forward and backward unchanged
                same = all(torch.equal(x, y) for x, y in zip(this, ref))
                what = "forward and backward"
            else:  # the backward on R's forward in both
                this = run(libs["this"], q, k, v, g, causal,
                           fwd_from=libs["root"])
                same = all(torch.equal(x, y) for x, y in zip(this, ref))
                what = "backward on R's forward"
            print(f"[bits] {label} {str(dtype)[6:]}: {what} bit-equal to "
                  f"R's {same}; forward out relative L2 to R's "
                  f"{err_o:.3e}", flush=True)
            if not same:
                raise AssertionError(f"{label} {dtype}: bits differ")


def _device_ms(fn, iters: int = 20) -> float:
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


def paths(root: Path) -> None:
    os.chdir(root)
    sys.path.insert(0, str(root))
    from attention_models_torch.data.loaders import build_loader
    from attention_models_torch.longcontext import longcontext
    from attention_models_torch.models.factory import build_model
    from attention_models_torch.ops.ring_attention import ring_flash_attention
    from attention_models_torch.training.build_trainer import build_trainer

    _card()
    import chip_smoke as cs  # the trainer's configuration, as it builds it

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    res = dict(root=str(root), longcontext=[
        dict(t=r["t"], fwd_ms=r["fwd_ms"], fwd_bwd_ms=r["fwd_bwd_ms"])
        for r in longcontext()])
    gen = torch.Generator(device=dev).manual_seed(0)
    res["ring_fwd_bwd_ms"] = {}
    for causal in (False, True):
        q, k, v, g = (torch.randn(1, 8, 16384, 64, generator=gen, device=dev)
                      .bfloat16() for _ in range(4))
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]

        def step():
            out = ring_flash_attention(*leaves, 4, causal=causal)
            return torch.autograd.grad(out, leaves, g)
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        res["ring_fwd_bwd_ms"][f"causal={causal}"] = (
            (time.perf_counter() - t0) / 5 * 1e3)
    for mp, n in (("bf16", 4), ("no", 2)):
        cfg = cs.maskgit_config(mp)
        for key, val in cs.MASKGIT_TRAIN_OVERRIDES.items():
            cfg.set_path(key, val)
        cfg.set_path("experiment.output_dir",
                     str(root / "build" / f"bench_maskgit_{mp}"))
        trainer = build_trainer(cfg, build_model(cfg, device=dev),
                                build_loader(cfg), dev)
        img = trainer.to_device(next(iter(trainer.train_dl))[0])
        trainer.train_step(img)  # warm-up
        torch.cuda.synchronize()
        ms = []
        for _ in range(n):
            t0 = time.perf_counter()
            trainer.train_step(img)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        res[f"maskgit_train_{mp}_ms"] = ms
        del trainer, img
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("variants", "fwd32", "bits", "paths"))
    ap.add_argument("--source", default=None,
                    help="variants: one more backward source to time")
    ap.add_argument("--root", default=str(ROOT),
                    help="paths: the checkout to measure; bits: the one "
                         "to compare with")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_flash_bwd: needs a CUDA card", file=sys.stderr)
        return 2
    if args.mode == "variants":
        variants(args.source)
    elif args.mode == "fwd32":
        fwd32()
    elif args.mode == "bits":
        bits(Path(args.root).resolve())
    else:
        paths(Path(args.root).resolve())
    return 0


if __name__ == "__main__":
    sys.exit(main())
