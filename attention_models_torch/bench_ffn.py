"""A/B timings of the GEGLU FFN forward and backward (kernels 11 and 12) on
one card.

    python attention_models_torch/bench_ffn.py [--iters N]
        Kernels 11 and 12 at MaskGIT's shape (8192 rows, d 768, inner 4096),
        at Muse's (16384 rows, d 1024, inner 4096) and at inner 8704 (520
        rows, d 768: rows the row passes walk in chunks), bf16 and fp32
        (TF32 off): first the device time of each launch inside one call
        (torch.profiler, 20 calls); then the tile width of kernel 11's
        y W2^T in bf16 (256 as shipped, or 128: a plan built here, launched
        through amt_ffn) and the tile width of the fp32 FMA product (128,
        64, or the rule's choice) on the products of kernels 11, 12 and 14
        in fp32, each against the PyTorch chain, in turns: device time with
        the launches queued behind a sleep, every variant once in order,
        then once in reverse, twice over. A bf16 plan must give the shipped
        plan's bits; an fp32 width must stay within 1e-5 (relative L2) of
        torch.matmul.
    python attention_models_torch/bench_ffn.py variants [--iters N]
        Builds copies of csrc/ with csrc/gemm.cuh and csrc/ffn.cu edited
        (VARIANTS: the fp32 FMA product at one block an SM; its threads in
        warps of 4 x 8; the paired-column GEGLU product at BN 128), each
        into its own library under build/ffn_variants/, and prints the
        device time of kernels 11 and 12 in fp32 at MaskGIT's shape and of
        kernel 11 in bf16 at MaskGIT's and Muse's through each, in turns.

Needs a Hopper card and nvcc; the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from attention_models_torch.bench_mlp import (  # noqa: E402
    _card, _device_ms, _profile)

SHAPES = (("maskgit", 8192, 768, 4096), ("muse", 16384, 1024, 4096))
# rows wider than the 8192 columns the row passes hold in registers
WIDE = ("wide", 520, 768, 8704)
F32_WIDTHS = (0, 128, 64)  # 0: gemm_f32's own rule
# a warp as 4 x 8 threads of the 16 x 16 (two of them side by side, four
# deep) in place of 2 rows of 16: a k step's B reads one 128-byte run
_WARP_4X8 = ("tx = (tid / 32 % 2) * 8 + tid % 8, "
             "ty = tid / 64 * 4 + tid % 32 / 8",
             "tx = (threadIdx.x / 32 % 2) * 8 + threadIdx.x % 8, "
             "ty = threadIdx.x / 64 * 4 + threadIdx.x % 32 / 8")
_PAIRED = "sm90::gemm_from_plan<sm90::Paired, GegluF32, {}>("
# name: (the bf16 GEGLU product's tile width, edits (file in csrc/, old, new))
VARIANTS = {
    "shipped": (256, []),
    "fp32 product one block an SM": (256, [
        ("gemm.cuh", "__launch_bounds__(kRThreads, 2) void gemm_f32_kernel",
         "__launch_bounds__(kRThreads, 1) void gemm_f32_kernel"),
        ("ffn.cu", "__launch_bounds__(kRThreads, 2) void geglu_f32_kernel",
         "__launch_bounds__(kRThreads, 1) void geglu_f32_kernel")]),
    "fp32 product, warps of 4 x 8 threads": (256, [
        ("gemm.cuh", "tx = tid % 16, ty = tid / 16", _WARP_4X8[0]),
        ("gemm.cuh", "tx = threadIdx.x % 16, ty = threadIdx.x / 16",
         _WARP_4X8[1]),
        ("ffn.cu", "tx = threadIdx.x % 16, ty = threadIdx.x / 16",
         _WARP_4X8[1])]),
    "GEGLU product at BN 128": (128, [
        ("ffn.cu", _PAIRED.format(256), _PAIRED.format(128))]),
}


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _turns(fns: dict, iters: int) -> dict:
    """Device ms of each callable: once in order, once in reverse, twice."""
    times = {k: [] for k in fns}
    keys = list(fns)
    for seq in (keys, keys[::-1], keys, keys[::-1]):
        for k in seq:
            times[k].append(_device_ms(fns[k], iters))
    return times


def _operands(n, d, inner, dtype, gen):
    def r(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale
                + shift).to(dtype)
    return (r(n, d), r(2 * inner, d, scale=d ** -0.5),
            r(inner, scale=0.1, shift=1.0).float(),
            r(d, inner, scale=inner ** -0.5), r(n, d))


def _bf16_plan(n, d, inner, geglu_bn, out_bn):
    """Kernel 11's bf16 plan at the given tile widths, built as
    ``ffn_plan`` builds the shipped one."""
    from attention_models_torch.ops.ffn import FfnPlan
    from attention_models_torch.ops.gemm_sm90 import (
        K_MAJOR, gemm_plan, row_pitch, scratch_meta)

    x = scratch_meta("x", n, d, d)
    w1 = scratch_meta("w1", 2 * inner, d, d)
    w2 = scratch_meta("w2", d, inner, inner)
    y = scratch_meta("y", n, inner, row_pitch(inner))
    return FfnPlan(
        gemm_plan(x, K_MAJOR, w1, K_MAJOR, geglu_bn, row_pitch(inner),
                  paired=True, what="bench_ffn"),
        gemm_plan(y, K_MAJOR, w2, K_MAJOR, out_bn, d, what="bench_ffn"))


def _bf16_fwd(entry, plan, x, w1, gam, w2):
    """A callable launching kernel 11 in bf16 through ``entry`` (a
    library's amt_ffn) with ``plan``; it returns the output."""
    from attention_models_torch.ops import _build

    (n, d), inner = x.shape, w2.shape[1]
    g = torch.empty(n * plan.g_pitch, dtype=torch.float32, device="cuda")
    y = torch.empty(n * plan.y_pitch, dtype=torch.bfloat16, device="cuda")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def fwd():
        err = entry(plan.c_array(), x.data_ptr(), w1.data_ptr(),
                    gam.data_ptr(), w2.data_ptr(), g.data_ptr(), y.data_ptr(),
                    None, out.data_ptr(), n, d, inner, 1e-5,
                    _build.DTYPE_CODES[torch.bfloat16], stream)
        if err:
            raise RuntimeError(f"amt_ffn: CUDA error {err}")
        return out
    return fwd


def _chain(x, w1, gam, w2, inner):
    F = torch.nn.functional
    g = gam.to(x.dtype)

    def fwd():
        a, gate = F.linear(x, w1).chunk(2, dim=-1)
        return F.linear(F.layer_norm(gate * F.gelu(a), (inner,), g), w2)
    return fwd


def run(iters: int) -> None:
    from attention_models_torch.ops import _build, ffn
    from attention_models_torch.ops.gemm_sm90 import (
        K_MAJOR, MN_MAJOR, tile_product)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _card()
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, n, d, inner in (*SHAPES, WIDE):
        for dtype in (torch.bfloat16, torch.float32):
            x, w1, gam, w2, dy = _operands(n, d, inner, dtype, gen)
            dt = str(dtype).split(".")[-1]
            for k, fn in ((11, lambda: ffn.fused_ffn(x, w1, gam, w2)),
                          (12, lambda: ffn.fused_ffn_backward(x, w1, gam, w2,
                                                              dy))):
                per = _profile(fn)
                rows.append(dict(case=f"{label} {dt} kernel {k}",
                                 per_kernel_us=per))
                print(f"[ffn] {label} ({n},{d}) inner {inner} {dt} kernel "
                      f"{k} per launch (us): " + ", ".join(
                          f"{name} {us:.1f}" for name, us in per.items()),
                      flush=True)
            if dtype == torch.bfloat16 and label != WIDE[0]:
                shipped = ffn.fused_ffn(x, w1, gam, w2)
                fns = {"chain": _chain(x, w1, gam, w2, inner),
                       "W2 BN 256 (shipped)":
                           lambda: ffn.fused_ffn(x, w1, gam, w2)}
                fwd = _bf16_fwd(_build.library().amt_ffn, _bf16_plan(
                    n, d, inner, ffn.FFN_GEGLU_BN, 128), x, w1, gam, w2)
                fns[f"W2 BN 128 (same bits {torch.equal(fwd(), shipped)})"] = (
                    fwd)
                for name, ts in _turns(fns, iters).items():
                    rows.append(dict(case=f"{label} bf16 kernel 11",
                                     variant=name, ms=ts))
                    print(f"[ffn] {label} bf16 kernel 11 {name}: " + " / ".join(
                        f"{t:.4f}" for t in ts) + " ms", flush=True)
            del x, w1, gam, w2, dy
    # the fp32 FMA product's tile width on the shapes of kernels 11, 12 and
    # 14 in fp32 (M, N, K, A major, B major)
    n, d, inner, v = 8192, 768, 4096, 8192
    prods = (("11 GEGLU x W1^T", n, 2 * inner, d, K_MAJOR, K_MAJOR),
             ("11 y W2^T", n, d, inner, K_MAJOR, K_MAJOR),
             ("12 dy W2", n, inner, d, K_MAJOR, MN_MAJOR),
             ("12 dW2 = dy^T y", d, inner, n, MN_MAJOR, MN_MAJOR),
             ("12 dx", n, d, 2 * inner, K_MAJOR, MN_MAJOR),
             ("12 dW1", 2 * inner, d, n, MN_MAJOR, MN_MAJOR),
             ("14 dW = dl^T h", v, d, n, MN_MAJOR, MN_MAJOR))
    for label, m, nn, k, am, bm in prods:
        a = torch.randn(m, k, generator=gen, device="cuda")
        b = torch.randn(nn, k, generator=gen, device="cuda")
        sa = a if am == K_MAJOR else a.T.contiguous()
        sb = b if bm == K_MAJOR else b.T.contiguous()
        want = a @ b.T
        fns = {"torch.matmul": lambda: a @ b.T}
        for tw in F32_WIDTHS:
            err = _rel(tile_product(sa, am, sb, bm, tile_width=tw), want)
            if not err <= 1e-5:
                raise AssertionError(f"{label} width {tw}: rel_l2 {err}")
            fns[f"width {tw or 'rule'}"] = (
                lambda tw=tw: tile_product(sa, am, sb, bm, tile_width=tw))
        for name, ts in _turns(fns, iters).items():
            tf = 2 * m * nn * k / (sorted(ts)[1] * 1e-3) / 1e12
            rows.append(dict(case=f"fp32 {label} ({m},{nn},{k})", variant=name,
                             ms=ts))
            print(f"[f32] {label} ({m},{nn},{k}) {name}: " + " / ".join(
                f"{t:.4f}" for t in ts) + f" ms ({tf:.1f} TFLOP/s)", flush=True)
        del a, b, sa, sb, want
    print(json.dumps({"rows": rows}))


def variants(iters: int) -> None:
    from attention_models_torch.ops import _build, ffn

    torch.backends.cuda.matmul.allow_tf32 = False
    _card()
    csrc = ROOT / "attention_models_torch" / "csrc"
    out = ROOT / "build" / "ffn_variants"
    procs = {}
    for i, (name, (_, edits)) in enumerate(VARIANTS.items()):
        d = out / f"v{i}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        for fname, old, new in edits:
            text = (d / fname).read_text()
            if old not in text:
                raise ValueError(f"csrc/{fname} has no {old!r}")
            (d / fname).write_text(text.replace(old, new))
        cmd = [_build.nvcc_path(), *_build.ARCH, *_build.FLAGS, "-shared",
               *(str(d / f) for f in ("ffn.cu", "ffn_bwd.cu", "errors.cu")),
               "-o", str(d / "lib.so")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for fn in ("amt_ffn", "amt_ffn_bwd"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    n, d, inner = 8192, 768, 4096
    x, w1, gam, w2, dy = _operands(n, d, inner, torch.float32, gen)
    f32 = dict(dtype=torch.float32, device="cuda")
    g, y = torch.empty(n, inner, **f32), torch.empty(n, inner, **f32)
    h, dyl = torch.empty(n, 2 * inner, **f32), torch.empty(n, inner, **f32)
    dh = torch.empty(n, 2 * inner, **f32)
    gpart = torch.empty(-(-n // ffn.FFN_BWD_ROWS), inner, **f32)
    out, dx = torch.empty_like(x), torch.empty_like(x)
    dw1, dw2 = torch.empty(2 * inner, d, **f32), torch.empty(d, inner, **f32)
    dgam = torch.empty(inner, **f32)
    part = torch.empty(2 * max(n, 2 * inner) * d, **f32)  # split partials
    want = ffn.fused_ffn(x, w1, gam, w2)
    bf16 = {label: _operands(rows, dd, ii, torch.bfloat16, gen)[:4]
            for label, rows, dd, ii in SHAPES}
    want16 = {label: ffn.fused_ffn(*ops) for label, ops in bf16.items()}
    fns = {}
    for name, lib in libs.items():
        for label, rows, dd, ii in SHAPES:
            fwd16 = _bf16_fwd(lib.amt_ffn, _bf16_plan(
                rows, dd, ii, VARIANTS[name][0], ffn.FFN_OUT_BN),
                *bf16[label])
            print(f"[variant] {name}: kernel 11 bf16 at {label}'s shape "
                  f"bit-equal to the shipped library's: "
                  f"{torch.equal(fwd16(), want16[label])}", flush=True)
            fns[f"{name} kernel 11 bf16 {label}"] = fwd16

        def fwd(lib=lib, name=name):
            err = lib.amt_ffn(None, x.data_ptr(), w1.data_ptr(), gam.data_ptr(),
                              w2.data_ptr(), g.data_ptr(), y.data_ptr(),
                              part.data_ptr(), out.data_ptr(), n, d, inner,
                              1e-5, 0, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        def bwd(lib=lib, name=name):
            err = lib.amt_ffn_bwd(
                None, x.data_ptr(), w1.data_ptr(), gam.data_ptr(),
                w2.data_ptr(), dy.data_ptr(), h.data_ptr(), dyl.data_ptr(),
                y.data_ptr(), dh.data_ptr(), gpart.data_ptr(), part.data_ptr(),
                dx.data_ptr(), dw1.data_ptr(), dgam.data_ptr(), dw2.data_ptr(),
                n, d, inner, 1e-5, 0, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        fwd()
        print(f"[variant] {name}: kernel 11 fp32 bit-equal to the shipped "
              f"library's: {torch.equal(out, want)}", flush=True)
        fns[f"{name} kernel 11"] = fwd
        fns[f"{name} kernel 12"] = bwd
        per = _profile(fwd)
        per.update(_profile(bwd))
        print(f"[variant] {name} per launch (us): " + ", ".join(
            f"{k} {v:.1f}" for k, v in per.items()), flush=True)
    for name, ts in _turns(fns, iters).items():
        dt = "" if "bf16" in name else " fp32"
        print(f"[variant] {name}{dt}: " + " / ".join(f"{t:.4f}" for t in ts)
              + " ms", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="run",
                    choices=("run", "variants"))
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_ffn: CUDA is not available", file=sys.stderr)
        return 2
    if args.mode == "variants":
        variants(args.iters)
    else:
        run(args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
