"""A/B timings of the W8A8 blocks (kernels 19, 20 and 21), the LayerNorm
(kernel 3) and the decode-step sampling epilogue (kernel 15) on one card.

    python attention_models_torch/bench_q8.py [turns] [--iters N]
        Kernels 19 and 20 in bf16 and fp32 (TF32 off) at Muse's shape
        (16384 rows, d 1024, inner 4096) and at inner 8704 (520 rows, d
        768), kernel 21 in bf16 and fp32 at the int8 tokenizer's (8192
        rows, d 512, hid 1368) and at hid 8704 (520 rows, d 768), kernel 3
        at chip_smoke.py's shapes and kernel 15 at
        chip_smoke.py's six decode cases (8192 rows of 8192 classes, bf16
        and fp32, with and without CFG, given bits or Philox) and at C 16384
        (1024 rows, bf16 and fp32, Philox), each against its PyTorch chain
        in turns (device time with the launches queued behind a sleep:
        kernel, library, library, kernel), beside the bound; then each
        launch's device time of kernels 19, 20 and 21 (torch.profiler, 20
        calls; kernel 21 a call, with launches a call); then a diagnostic
        of kernel 15 at (8192, 8192) bf16 Philox: a build of
        csrc/sampling.cu without the noise, at iters 16 and at iters 0 (no
        threshold search), beside the kernel.
    python attention_models_torch/bench_q8.py bits --root R
        Builds the kernels' library of the checkout at R (the parent:
        unpack it with git archive under build/) beside this one's and
        requires kernel 3 to give R's bits at every shape above, kernels 19
        and 20 R's codes, scales, g and output on every row at Muse's shape
        in both dtypes, kernel 21 R's y codes and scales, g, gelu codes and
        scales and output on every row at the tokenizer's shape and at hid
        8704 in both dtypes, kernel 6 (csrc/ln_mlp_bwd.cu, whose dual
        product's epilogue now sits in csrc/gemm_sm90.cuh) R's gradients at
        (8192, 512), hid 1368, and kernel 15 R's picks on every row of the six
        decode cases (scores within relative 2e-6); then the kernel-15
        diagnostic of ``turns`` on R's source.
    python attention_models_torch/bench_q8.py paths [--root R]
        Prints one JSON line for the checkout at R (default: this one):
        Muse's int8_wide and int8 generates (cfg/muse.yaml as R's
        chip_smoke.py builds it, bf16, 8 prompts, 18 steps, approx top-k)
        through muse_service, ms/step over 5 generates after a warm-up, and
        the card's busy time of one generate by kernel (torch.profiler);
        then MaskGIT's unconditional generate (cfg/maskgit.yaml, bf16, batch
        8, 18 steps, approx top-k, as chip_smoke.py's phase 8), ms/step the
        same way and the sampling epilogue's device time in one generate. To
        compare two commits, run it at the parent (unpacked under build/)
        and at this checkout in turns, parent, change, change, parent, in
        one call; run it as a file, so the package is imported from R.

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
HBM = 3.35e12
PEAK = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
MUSE = (16384, 1024, 4096)
WIDE = (520, 768, 8704)
TOKENIZER = (8192, 512, 1368)  # kernel 21: rows, d, hid
# kernel 15: (rows, C, dtype, CFG, Philox): chip_smoke.py's decode cases,
# then rows wider than the 8192 values a block holds in registers
EPILOGUE = tuple((8192, 8192, dt, null, philox)
                 for dt, null, philox in ((torch.bfloat16, False, False),
                                          (torch.bfloat16, True, False),
                                          (torch.float32, False, False),
                                          (torch.float32, True, False),
                                          (torch.bfloat16, False, True),
                                          (torch.float32, False, True))) + (
    (1024, 16384, torch.bfloat16, False, True),
    (1024, 16384, torch.float32, False, True))
P_KEEP, GS, STEP = 0.9, 3.0, 5
# kernel 15's diagnostic build: no value is kept, so no noise is drawn
NO_NOISE = ("const bool kept = in && v[j][w] >= kth;", "const bool kept = false;")
TEMP = 17 / 18
# (rows, d, dtype, beta): chip_smoke.py's LayerNorm shapes
LN_SHAPES = ((8192, 512, torch.bfloat16, True), (8192, 512, torch.float32, True),
             (8192, 192, torch.float32, True), (8192, 192, torch.bfloat16, True),
             (8192, 768, torch.bfloat16, False), (8192, 768, torch.float32, False),
             (16384, 1024, torch.bfloat16, False), (616, 768, torch.bfloat16, True),
             (1024, 8192, torch.bfloat16, False))


def _card() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} | {smi}", flush=True)


def _helpers():
    """bench_mlp.py's device timing and profile, from this checkout."""
    sys.path.insert(0, str(ROOT))
    from attention_models_torch.bench_mlp import _device_ms, _profile
    return _device_ms, _profile


def _helpers_split():
    """bench_mlp.py's per-call launch split, from this checkout."""
    sys.path.insert(0, str(ROOT))
    from attention_models_torch.bench_mlp import _launch_split
    return _launch_split


def _rand(gen, *shape, dtype=torch.float32, scale=1.0, shift=0.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale
            + shift).to(dtype)


def _q8_operands(gen, n, d, inner, dtype):
    """Kernel 19's x, W1q, gamma and W2q, quantized from fp32 weights."""
    from attention_models_torch.ops import quant as q
    x, w1, gam, q2 = _q8wide_operands(gen, n, d, inner, dtype)
    return x, q.quantize_weight(w1), gam, q2


def _epilogue_case(gen, rows, C, dtype, null, philox):
    """Kernel 15's operands and keyword arguments for one case: logits of
    scale 3 in 8 leading rows, the seeds, or given bits."""
    from attention_models_torch.ops.sampling import philox_bits
    cond = _rand(gen, 8, rows // 8, C, dtype=dtype, scale=3.0)
    nl = _rand(gen, 8, rows // 8, C, dtype=dtype, scale=3.0) if null else None
    seeds = torch.arange(100, 108, device="cuda")
    ext = None if philox else torch.randint(
        -2 ** 31, 2 ** 31 - 1, (8, rows // 8, C), generator=gen,
        device="cuda", dtype=torch.int32)
    bits = (philox_bits(seeds, rows // 8, STEP, C) if philox
            else ext.reshape(-1, C))
    kw = dict(guidance_scale=GS, p=P_KEEP, temperature=TEMP, seeds=seeds,
              step=STEP, noise_bits=ext)
    label = (f"({rows},{C}) {str(dtype)[6:]} null={null} "
             f"bits={'philox' if philox else 'given'}")
    return cond, nl, bits, kw, label


def _ln_mlp_q8_operands(gen, n, d, hid, dtype):
    """Kernel 21's x, LN affine, W1q, b1, W2q and b2 (chip_smoke.py's)."""
    from attention_models_torch.ops import quant as q
    x = _rand(gen, n, d, dtype=dtype)
    lng, lnb = _rand(gen, d, scale=0.1, shift=1.0), _rand(gen, d, scale=0.1)
    q1 = q.quantize_weight(_rand(gen, hid, d, scale=d ** -0.5))
    q2 = q.quantize_weight(_rand(gen, d, hid, scale=hid ** -0.5))
    b1, b2 = _rand(gen, hid, scale=0.1), _rand(gen, d, scale=0.1)
    return x, lng, lnb, q1, b1, q2, b2


def _q8wide_operands(gen, n, d, inner, dtype):
    from attention_models_torch.ops import quant as q
    x = _rand(gen, n, d, dtype=dtype)
    w1 = _rand(gen, 2 * inner, d, scale=d ** -0.5)
    gam = _rand(gen, inner, scale=0.1, shift=1.0)
    q2 = q.quantize_weight(_rand(gen, d, inner, scale=inner ** -0.5))
    return x, w1, gam, q2


def turns(iters: int) -> None:
    _device_ms, _profile = _helpers()
    from attention_models_torch.ops import _build
    from attention_models_torch.ops import quant as q
    from attention_models_torch.ops.layernorm import layernorm

    F = torch.nn.functional
    torch.backends.cuda.matmul.allow_tf32 = False
    _card()
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def in_turns(label, run, lib, bound_ms):
        k1, l1, l2, k2 = (_device_ms(run, iters), _device_ms(lib, iters),
                          _device_ms(lib, iters), _device_ms(run, iters))
        k, lb = (k1 + k2) / 2, (l1 + l2) / 2
        print(f"[turns] {label}: kernel {k1:.4f} / {k2:.4f} ms, library "
              f"{l1:.4f} / {l2:.4f} ms, kernel/library {k / lb:.3f}; bound "
              f"{bound_ms:.4f} ms ({100 * bound_ms / k:.1f} % of it)",
              flush=True)

    for n, d, inner in (MUSE, WIDE):
        for dtype in (torch.bfloat16, torch.float32):
            x, w1, gam, q2 = _q8wide_operands(gen, n, d, inner, dtype)
            w1c = w1.to(dtype)

            def chain():
                a, gate = F.linear(x, w1c).float().chunk(2, dim=-1)
                y = F.layer_norm(gate * F.gelu(a), (inner,), gam)
                yq, sy = q.quantize_rows(y)
                return (q.int_dot(yq, q2.q) * sy * q2.scale).to(dtype)

            def run():
                return q.fused_ffn_q8wide(x, w1, gam, q2)

            peak = PEAK[str(dtype).split(".")[-1]]
            bound = (4 * n * d * inner / peak
                     + 2 * n * d * inner / PEAK["int8"]) * 1e3
            label = f"20 ({n},{d}) inner {inner} {str(dtype)[6:]}"
            in_turns(label, run, chain, bound)
            prof = _profile(run)
            total = sum(prof.values())
            print(f"[launches] {label}: " + ", ".join(
                f"{k} {v:.1f} us ({100 * v / total:.1f} %)"
                for k, v in sorted(prof.items(), key=lambda kv: -kv[1])),
                flush=True)
            del x, w1, w1c, q2
    for n, d, inner in (MUSE, WIDE):
        for dtype in (torch.bfloat16, torch.float32):
            x, q1, gam, q2 = _q8_operands(gen, n, d, inner, dtype)

            def chain():
                xq, sx = q.quantize_rows(x.float())
                a, gate = (q.int_dot(xq, q1.q) * sx * q1.scale).chunk(2, -1)
                y = F.layer_norm(gate * F.gelu(a), (inner,), gam)
                yq, sy = q.quantize_rows(y)
                return (q.int_dot(yq, q2.q) * sy * q2.scale).to(dtype)

            def run():
                return q.fused_ffn_q8(x, q1, gam, q2)

            label = f"19 ({n},{d}) inner {inner} {str(dtype)[6:]}"
            in_turns(label, run, chain,
                     6 * n * d * inner / PEAK["int8"] * 1e3)
            prof = _profile(run)
            total = sum(prof.values())
            print(f"[launches] {label}: " + ", ".join(
                f"{k} {v:.1f} us ({100 * v / total:.1f} %)"
                for k, v in sorted(prof.items(), key=lambda kv: -kv[1])),
                flush=True)
            del x, q1, q2
    _launch_split = _helpers_split()
    for n, d, hid in (TOKENIZER, WIDE):
        for dtype in (torch.bfloat16, torch.float32):
            a21 = _ln_mlp_q8_operands(gen, n, d, hid, dtype)
            x, lng, lnb, q1, b1, q2, b2 = a21

            def chain():
                xq, sx = q.quantize_rows(F.layer_norm(x.float(), (d,), lng,
                                                      lnb))
                gq, sg = q.quantize_rows(F.gelu(
                    q.int_dot(xq, q1.q) * sx * q1.scale + b1))
                return (x.float() + q.int_dot(gq, q2.q) * sg * q2.scale
                        + b2).to(dtype)

            def run():
                return q.fused_ln_mlp_q8(*a21)

            label = f"21 ({n},{d}) hid {hid} {str(dtype)[6:]}"
            in_turns(label, run, chain, 4 * n * d * hid / PEAK["int8"] * 1e3)
            split = _launch_split(run)
            print(f"[launches] {label}: device time a call "
                  f"{sum(us for us, _ in split.values()):.1f} us; " + "; ".join(
                      f"{k} {us:.1f} us x {c:g}" for k, (us, c) in sorted(
                          split.items(), key=lambda kv: -kv[1][0])),
                  flush=True)
            del x, q1, q2, a21
    for rows, d, dtype, beta in LN_SHAPES:
        x = _rand(gen, rows, d, dtype=dtype, scale=2.0, shift=0.5)
        g = _rand(gen, d, scale=0.1, shift=1.0)
        b = _rand(gen, d, scale=0.1) if beta else None
        gl, bl = g.to(dtype), (b.to(dtype) if beta else None)
        nbytes = 2 * x.numel() * x.element_size() + 4 * d * (1 + beta)
        in_turns(f"3 ({rows},{d}){'' if beta else ' no beta'} "
                 f"{str(dtype)[6:]}", lambda: layernorm(x, g, b),
                 lambda: F.layer_norm(x, (d,), gl, bl), nbytes / HBM * 1e3)
    epilogue_turns(gen, in_turns)


def epilogue_turns(gen, in_turns) -> None:
    """Kernel 15 at each case against topk + Gumbel argmax + logsumexp, in
    turns beside its bytes bound; then its diagnostic."""
    from attention_models_torch.ops import _build
    from attention_models_torch.ops.sampling import (
        gumbel_of_bits, num_kept, sample_epilogue_fused)

    for rows, C, dtype, null, philox in EPILOGUE:
        cond, nl, bits, kw, label = _epilogue_case(gen, rows, C, dtype, null,
                                                   philox)
        k = num_kept(C, P_KEEP)
        g_k = gumbel_of_bits(bits[:, :k])

        def library():
            xl = cond if nl is None else nl + GS * (cond - nl)
            vals, idx = torch.topk(xl.reshape(-1, C), k)
            choice = (vals.float() + TEMP * g_k).argmax(-1, keepdim=True)
            lse = torch.logsumexp(xl.reshape(-1, C).float(), -1)
            return (idx.gather(-1, choice),
                    torch.exp(vals.gather(-1, choice)[:, 0].float() - lse))

        nbytes = sum(t.numel() * t.element_size() for t in (cond, nl)
                     if t is not None) + (0 if philox else 4 * rows * C) + 8 * rows
        in_turns(f"15 {label}", lambda: sample_epilogue_fused(cond, nl, **kw),
                 library, nbytes / HBM * 1e3)
        del cond, nl, bits, g_k
    lib = _variant_library(ROOT, "sampling.cu", NO_NOISE)
    epilogue_diag(gen, "", _build.library(), lib)


def epilogue_diag(gen, who, shipped, no_noise) -> None:
    """Kernel 15 at (8192, 8192) bf16 Philox through ``shipped``'s entry and
    through a build without the noise (``no_noise``) at iters 16 and 0 (no
    threshold search): what the noise, the search and the rest take."""
    from attention_models_torch.ops import _build
    from attention_models_torch.ops.sampling import num_kept

    rows, C = 8192, 8192
    cond, _, _, kw, _ = _epilogue_case(gen, rows, C, torch.bfloat16, False,
                                       True)
    pred = torch.empty(rows, dtype=torch.int32, device="cuda")
    score = torch.empty(rows, device="cuda")
    seeds = kw["seeds"]
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib, iters):
        return lambda: lib.amt_sample_epilogue(
            cond.data_ptr(), None, None, seeds.data_ptr(), rows // 8, STEP,
            pred.data_ptr(), score.data_ptr(), rows, C, num_kept(C, P_KEEP),
            iters, GS, TEMP, _build.DTYPE_CODES[torch.bfloat16], stream)

    for label, fn in (("kernel", call(shipped, 16)),
                      ("without the noise", call(no_noise, 16)),
                      ("without the noise and the threshold search (iters "
                       "0)", call(no_noise, 0))):
        ms = [_device_ms_raw(fn) for _ in range(2)]
        print(f"[diag] {who}15 ({rows},{C}) bfloat16 Philox {label}: "
              f"{ms[0]:.4f} / {ms[1]:.4f} ms", flush=True)


def _device_ms_raw(fn, iters: int = 20) -> float:
    """Device time of a C entry's launch (the return code checked)."""
    def run():
        err = fn()
        if err:
            raise RuntimeError(f"CUDA error {err}")
    _device_ms, _ = _helpers()
    return _device_ms(run, iters)


def _variant_library(root: Path, source: str, *edits) -> ctypes.CDLL:
    """``source`` of the checkout at ``root``'s csrc with each (old, new)
    edit, built alone (with errors.cu) into a library under
    build/q8_variants."""
    from attention_models_torch.ops import _build
    csrc = root / "attention_models_torch" / "csrc"
    _variant_library.built += 1  # a new path: dlopen reuses a loaded one
    out = ROOT / "build" / "q8_variants" / f"{root.name}{_variant_library.built}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    text = (out / source).read_text()
    for old, new in edits:
        if old not in text:
            raise ValueError(f"csrc/{source} has no {old!r}")
        text = text.replace(old, new)
    (out / source).write_text(text)
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.ARCH, *_build.FLAGS, "-shared",
         str(out / source), str(out / "errors.cu"), "-o", str(out / "lib.so")],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out / "lib.so"))
    lib.amt_sample_epilogue.argtypes = _build._SIGNATURES["amt_sample_epilogue"]
    lib.amt_sample_epilogue.restype = ctypes.c_int
    return lib


_variant_library.built = 0


def _library_of(root: Path) -> ctypes.CDLL:
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.'); from "
         "attention_models_torch.ops import _build; print(_build.build())"],
        cwd=root, capture_output=True, text=True, check=True)
    return ctypes.CDLL(out.stdout.strip().splitlines()[-1])


def bits(root: Path) -> None:
    _helpers()
    from attention_models_torch.ops import _build
    from attention_models_torch.ops import quant as q
    from attention_models_torch.ops.sampling import num_kept

    _card()
    this, other = _build.library(), _library_of(root)
    sig = _build._SIGNATURES
    for fn in ("amt_layernorm", "amt_ffn_q8wide", "amt_ffn_q8",
               "amt_sample_epilogue", "amt_ln_mlp_bwd"):
        getattr(other, fn).argtypes = sig[fn]
    # R's kernel 21 entry takes no plan; its W2q and gelu codes are rows
    # padded to 16 bytes with zero columns
    other.amt_ln_mlp_q8.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 4
                                    + [ctypes.c_float, ctypes.c_int,
                                       ctypes.c_void_p])
    for fn in ("amt_layernorm", "amt_ffn_q8wide", "amt_ffn_q8",
               "amt_sample_epilogue", "amt_ln_mlp_bwd", "amt_ln_mlp_q8"):
        getattr(other, fn).restype = ctypes.c_int
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    same_all = True

    def check(err, name):
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")

    for rows, d, dtype, beta in LN_SHAPES:
        x = _rand(gen, rows, d, dtype=dtype, scale=2.0, shift=0.5)
        g = _rand(gen, d, scale=0.1, shift=1.0)
        b = _rand(gen, d, scale=0.1) if beta else None
        ys = [torch.empty_like(x), torch.empty_like(x)]
        for lib, y in zip((this, other), ys):
            check(lib.amt_layernorm(x.data_ptr(), g.data_ptr(),
                                    b.data_ptr() if beta else None,
                                    y.data_ptr(), rows, d, 1e-5,
                                    _build.DTYPE_CODES[dtype], stream),
                  "amt_layernorm")
        torch.cuda.synchronize()
        same = torch.equal(ys[0], ys[1])
        differ = int((ys[0] != ys[1]).sum())
        same_all &= same
        print(f"[bits] 3 ({rows},{d}){'' if beta else ' no beta'} "
              f"{str(dtype)[6:]}: bit-equal to R's {same} ({differ} of "
              f"{x.numel()} values differ)", flush=True)
    n, d, inner = MUSE
    f32, i8 = dict(dtype=torch.float32, device="cuda"), dict(
        dtype=torch.int8, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        # kernel 19: x's codes and scales, g, y's codes and scales, out
        x, q1, gam, q2 = _q8_operands(gen, n, d, inner, dtype)
        plan = q.q8_plan(n, d, inner)
        outs = []
        for lib in (this, other):
            xq, sx = torch.empty(n, d, **i8), torch.empty(n, **f32)
            g, yq = torch.empty(n, inner, **f32), torch.empty(n, inner, **i8)
            sy, out = torch.empty(n, **f32), torch.empty_like(x)
            ptrs = (x.data_ptr(), q1.q.data_ptr(), q1.scale.data_ptr(),
                    gam.data_ptr(), q2.q.data_ptr(), q2.scale.data_ptr(),
                    xq.data_ptr(), sx.data_ptr(), g.data_ptr(), yq.data_ptr(),
                    sy.data_ptr(), out.data_ptr(), n, d, inner, 1e-5,
                    _build.DTYPE_CODES[dtype], stream)
            check(lib.amt_ffn_q8(plan.c_array(), *ptrs), "amt_ffn_q8")
            outs.append((xq, sx, g, yq, sy, out))
        torch.cuda.synchronize()
        names = ("x codes", "x scales", "g", "y codes", "y scales", "out")
        rows_same = torch.ones(n, dtype=torch.bool, device="cuda")
        for t0, t1 in zip(*outs):
            eq = t0 == t1
            rows_same &= eq.all(dim=1) if eq.dim() == 2 else eq
        differ = {nm: int((t0 != t1).sum())
                  for nm, t0, t1 in zip(names, *outs)}
        same = bool(rows_same.all())
        same_all &= same
        print(f"[bits] 19 ({n},{d}) inner {inner} {str(dtype)[6:]}: every row "
              f"bit-equal to R's (codes, scales, g, out) {same} "
              f"({int(rows_same.sum())} of {n} rows; values differing "
              f"{differ})", flush=True)
        del x, q1, q2, outs
        # kernel 20 (its plan is R's): y's codes and scales and out
        x, w1, gam, q2 = _q8wide_operands(gen, n, d, inner, dtype)
        w1c = w1.to(dtype).contiguous()
        plan = q.q8wide_plan(n, d, inner)
        outs = []
        for lib in (this, other):
            g = torch.empty(n * plan.g_pitch, **f32)
            yq = torch.empty(n, inner, **i8)
            sy, out = torch.empty(n, **f32), torch.empty_like(x)
            check(lib.amt_ffn_q8wide(
                plan.c_array(), x.data_ptr(), w1c.data_ptr(), gam.data_ptr(),
                q2.q.data_ptr(), q2.scale.data_ptr(), g.data_ptr(),
                yq.data_ptr(), sy.data_ptr(), out.data_ptr(), n, d, inner,
                1e-5, _build.DTYPE_CODES[dtype], stream), "amt_ffn_q8wide")
            outs.append((yq, sy, out))
        torch.cuda.synchronize()
        same = all(torch.equal(t0, t1) for t0, t1 in zip(*outs))
        same_all &= same
        print(f"[bits] 20 ({n},{d}) inner {inner} {str(dtype)[6:]}: codes, "
              f"scales and out bit-equal to R's: {same}", flush=True)
        del x, w1, w1c, q2, outs
    for n, d, hid in (TOKENIZER, WIDE):
        for dtype in (torch.bfloat16, torch.float32):
            same = _bits_21(this, other, gen, n, d, hid, dtype, stream)
            same_all &= same
    same_all &= _bits_6(this, other, gen, stream)
    # kernel 15: R's picks on every row, scores within relative 2e-6
    for rows, C, dtype, null, philox in EPILOGUE:
        if C > 8192:
            continue
        cond, nl, bits_, kw, label = _epilogue_case(gen, rows, C, dtype, null,
                                                    philox)
        ext = kw["noise_bits"]
        res = []
        for lib in (this, other):
            pred = torch.empty(rows, dtype=torch.int32, device="cuda")
            score = torch.empty(rows, **f32)
            args = (cond.data_ptr(), nl.data_ptr() if nl is not None else None,
                    ext.data_ptr() if ext is not None else None,
                    kw["seeds"].data_ptr(), rows // 8, STEP, pred.data_ptr(),
                    score.data_ptr(), rows, C, num_kept(C, P_KEEP), 16, GS,
                    TEMP, _build.DTYPE_CODES[dtype], stream)
            check(lib.amt_sample_epilogue(*args), "amt_sample_epilogue")
            res.append((pred, score))
        torch.cuda.synchronize()
        (p0, s0), (p1, s1) = res
        picks = torch.equal(p0, p1)
        rel = float(((s0 - s1).abs() / s1).max())
        same = picks and rel <= 2e-6
        same_all &= same
        print(f"[bits] 15 {label}: picks equal to R's on every row {picks}, "
              f"scores bit-equal {torch.equal(s0, s1)}, largest relative "
              f"score difference {rel:.3e} (tol 2e-6)", flush=True)
        del cond, nl, bits_, ext
    epilogue_diag(gen, "R's ", other, _variant_library(root, "sampling.cu",
                                                      NO_NOISE))
    if not same_all:
        raise AssertionError("bits differ from R's")


def _rows_equal(outs, n) -> tuple[bool, dict]:
    """Whether every row of each (this, R) pair of tensors, each of n rows,
    is bit-equal, and the values that differ by name."""
    rows_same = torch.ones(n, dtype=torch.bool, device="cuda")
    differ = {}
    for name, (t0, t1) in outs.items():
        eq = t0 == t1
        rows_same &= eq.reshape(n, -1).all(dim=1)
        differ[name] = int((~eq).sum())
    return bool(rows_same.all()), differ


def _bits_21(this, other, gen, n, d, hid, dtype, stream) -> bool:
    """Kernel 21 through this library's plan and R's plan-free entry: y's
    codes and scales, g, the gelu codes and scales and the output on every
    row."""
    from attention_models_torch.ops import _build
    from attention_models_torch.ops import quant as q
    x, lng, lnb, q1, b1, q2, b2 = _ln_mlp_q8_operands(gen, n, d, hid, dtype)
    f32, i8 = (dict(dtype=dt, device="cuda") for dt in (torch.float32,
                                                        torch.int8))
    plan = q.ln_mlp_q8_plan(n, d, hid)
    yq, g = torch.empty(n, plan.y_pitch, **i8), torch.empty(n, plan.g_pitch, **f32)
    gq, w2s = torch.empty(n, plan.q_pitch, **i8), torch.empty(
        max(plan.w2_stage_bytes, 1), **i8)
    sy, sg, out = torch.empty(n, **f32), torch.empty(n, **f32), torch.empty_like(x)
    code = _build.DTYPE_CODES[dtype]
    err = this.amt_ln_mlp_q8(
        plan.c_array(), x.data_ptr(), lng.data_ptr(), lnb.data_ptr(),
        q1.q.data_ptr(), q1.scale.data_ptr(), b1.data_ptr(), q2.q.data_ptr(),
        q2.scale.data_ptr(), b2.data_ptr(),
        w2s.data_ptr() if plan.w2_stage_bytes else None, yq.data_ptr(),
        sy.data_ptr(), g.data_ptr(), gq.data_ptr(), sg.data_ptr(),
        out.data_ptr(), n, d, hid, 1e-5, code, stream)
    hid_pad = -(-hid // 16) * 16
    w2p = torch.nn.functional.pad(q2.q, (0, hid_pad - hid)).contiguous()
    yq_r, g_r = torch.empty(n, d, **i8), torch.empty(n, hid, **f32)
    gq_r = torch.empty(n, hid_pad, **i8)
    sy_r, sg_r, out_r = (torch.empty(n, **f32), torch.empty(n, **f32),
                         torch.empty_like(x))
    err_r = other.amt_ln_mlp_q8(
        x.data_ptr(), lng.data_ptr(), lnb.data_ptr(), q1.q.data_ptr(),
        q1.scale.data_ptr(), b1.data_ptr(), w2p.data_ptr(),
        q2.scale.data_ptr(), b2.data_ptr(), yq_r.data_ptr(), sy_r.data_ptr(),
        g_r.data_ptr(), gq_r.data_ptr(), sg_r.data_ptr(), out_r.data_ptr(),
        n, d, hid, hid_pad, 1e-5, code, stream)
    if err or err_r:
        raise RuntimeError(f"amt_ln_mlp_q8: CUDA errors {err} / {err_r}")
    torch.cuda.synchronize()
    same, differ = _rows_equal({
        "y codes": (yq[:, :d], yq_r), "y scales": (sy, sy_r),
        "g": (g[:, :hid], g_r), "gelu codes": (gq[:, :hid], gq_r[:, :hid]),
        "gelu scales": (sg, sg_r), "out": (out, out_r)}, n)
    print(f"[bits] 21 ({n},{d}) hid {hid} {str(dtype)[6:]}: every row "
          f"bit-equal to R's (y codes and scales, g, gelu codes and scales, "
          f"out) {same} (values differing {differ})", flush=True)
    return same


def _bits_6(this, other, gen, stream) -> bool:
    """Kernel 6 at (8192, 512), hid 1368 through this library and R's (the
    same plan and scratch layout): dx and the fp32 gradients bit-equal."""
    from attention_models_torch.ops import ffn
    n, d, hid = TOKENIZER
    x, dy = (_rand(gen, n, d, dtype=torch.bfloat16) for _ in range(2))
    lng, lnb = _rand(gen, d, scale=0.1, shift=1.0), _rand(gen, d, scale=0.1)
    w1 = _rand(gen, hid, d, dtype=torch.bfloat16, scale=d ** -0.5)
    w2 = _rand(gen, d, hid, dtype=torch.bfloat16, scale=hid ** -0.5)
    b1 = _rand(gen, hid, scale=0.1)
    plan = ffn.ln_mlp_bwd_plan(dy, w1, w2)
    f32 = dict(dtype=torch.float32, device="cuda")
    res = []
    for lib in (this, other):
        bufs, scratch = ffn._scratch(plan, "cuda", torch.bfloat16)
        dx = torch.empty_like(x)
        outs = (torch.empty(hid, d, **f32), torch.empty(hid, **f32),
                torch.empty(d, hid, **f32), torch.empty(3, d, **f32))
        err = lib.amt_ln_mlp_bwd(
            plan.c_array(), x.data_ptr(), lng.data_ptr(), lnb.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), *(t.data_ptr() for t in outs), *scratch, n, d,
            hid, 1e-5, stream)
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"amt_ln_mlp_bwd: CUDA error {err}")
        res.append((dx, *outs))
    same = all(torch.equal(a, b) for a, b in zip(*res))
    print(f"[bits] 6 ({n},{d}) hid {hid} bfloat16: dx, dW1, db1, dW2 and "
          f"dlng / dlnb / db2 bit-equal to R's: {same}", flush=True)
    return same


def paths(root: Path) -> None:
    os.chdir(root)
    sys.path.insert(0, str(root))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from attention_models_torch.models.factory import build_model
    from attention_models_torch.models.text_encoder import tokenize
    from attention_models_torch.serving import maskgit_service, muse_service

    _card()
    import chip_smoke as cs  # the configuration, as R builds it

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    def timed(call):
        """ms/step of 5 generates after a warm-up, sorted; the busy time of
        one more by kernel (ms)."""
        def once():
            torch.cuda.synchronize()
            t = time.perf_counter()
            call()
            torch.cuda.synchronize()
            return time.perf_counter() - t

        once()
        times = sorted(once() / 18 * 1e3 for _ in range(5))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        busy = {}
        for e in prof.key_averages():
            t = (getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0))
            if e.device_type == DeviceType.CUDA and t > 0:
                name = e.key.replace("(anonymous namespace)::", "")
                name = name.split("(")[0][-60:]
                busy[name] = busy.get(name, 0.0) + t / 1e3
        return times, busy

    def summary(times, busy):
        total = sum(busy.values())
        top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
        return dict(ms_per_step=times, median_ms_per_step=times[2],
                    busy_ms=total, top=[(k, v, v / total) for k, v in top])

    res = dict(root=str(root))
    text_ids, seeds = tokenize(cs.MUSE_PROMPTS), list(range(8))
    for quant in ("int8_wide", "int8"):
        mm = build_model(cs.muse_config("bf16", quant), device=dev).eval()
        svc = muse_service(mm, timesteps=18, approx_topk=True)
        res[f"muse_{quant}"] = summary(*timed(lambda: svc(text_ids, seeds)))
        del mm, svc
        torch.cuda.empty_cache()
    mg = build_model(cs.maskgit_config("bf16"), device=dev).eval()
    svc = maskgit_service(mg, timesteps=18, num_masked=1024, approx_topk=True)
    times, busy = timed(lambda: svc({}, seeds))
    res["maskgit_ms_per_step"] = times
    res["maskgit_sample_epilogue_ms_per_generate"] = sum(
        v for k, v in busy.items() if "sample_epilogue" in k)
    print(json.dumps(res), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="turns",
                    choices=("turns", "bits", "paths"))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="bits: the checkout to compare with; paths: the "
                         "checkout to measure")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_q8: needs a CUDA card", file=sys.stderr)
        return 2
    if args.mode == "turns":
        turns(args.iters)
    elif args.mode == "bits":
        bits(args.root.resolve())
    else:
        paths(args.root.resolve())
    return 0


if __name__ == "__main__":
    sys.exit(main())
