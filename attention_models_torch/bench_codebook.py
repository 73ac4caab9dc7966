"""A/B timings of the nearest-code argmin (kernel 4, csrc/codebook.cu) on
one card.

    python attention_models_torch/bench_codebook.py [turns] [--iters N]
        Kernel 4 on L2-normalised tokens and codes at the main path's
        (8192, 32) x 8192 and at widths 8, 64 and 20 (20: the first design),
        bf16 and fp32, against the faster of two library chains (cdist +
        argmin; addmm(|e|^2, z, codes^T, alpha=-2).argmin on fp32 operands,
        TF32 off, the same function for bf16 inputs, whose products are
        exact in fp32) in turns (device time with the launches queued
        behind a sleep: kernel, library, library, kernel) and back to back,
        beside the bound (2 n k d operations at the dtype's peak).
    python attention_models_torch/bench_codebook.py split
        At (8192, 32) x 8192, bf16 and fp32: each launch's device time of a
        call (torch.profiler: the |e|^2 pass, the argmin kernel with its
        slice combine), then the argmin kernel's product and epilogue apart: a
        build of csrc/codebook.cu whose epilogue is cut (bf16: no epilogue,
        the wgmma products and the ring alone; fp32: a running min without
        its index), a diagnostic whose indices are not read, timed in
        turns against the shipped build.
    python attention_models_torch/bench_codebook.py variants
        The bf16 tile rows at widths 8, 16 and 32: the shipped rows (the
        width, at least one 32-byte wgmma k step, with that swizzle) against
        a build with csrc/gemm_sm90.cuh's 128-byte K slice (TMA's zero fill
        past the width, four k steps a chunk); then the fp32 tiles at width
        64, the width unrolled 8 at a time (shipped) against whole; in
        turns, same indices required.
    python attention_models_torch/bench_codebook.py bits --root R
        Builds the kernels' library of the checkout at R (the parent:
        unpack it with git archive under build/) beside this one's and
        requires this kernel's fp32 indices at widths 8, 32 and 64 to equal
        R's bit for bit; bf16 at widths 8, 16, 32 and 64: the agreement with
        R and, where the two differ, the largest plain top-2 gap; each
        beside both kernels' device time in turns (R, this, this, R).

Needs a Hopper card and nvcc; the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PEAK = {torch.bfloat16: 989e12, torch.float32: 67e12}
N_TOK, N_CODES = 8192, 8192  # vitvqgan_base: batch 8 x 1024 tokens, 8192 codes
# (dtype, edits of csrc/codebook.cu) of the split's diagnostic builds
CUT_EPILOGUE = {
    torch.bfloat16: [("""    if (ce - c0 >= kChunk)
      am.run<false>(acc, es, c0, kChunk);
    else
      am.run<true>(acc, es, c0, ce - c0);""", "    (void)es;")],
    torch.float32: [("""        if (dist < best[r]) {
          best[r] = dist;
          bidx[r] = c0 + col;
        }""", "        best[r] = fminf(best[r], dist);")],
}
WIDE_ROWS = [("return 2 * D < 32 ? 32 : 2 * D;", "return 128;")]
WHOLE_64 = [("#pragma unroll(D <= 32 ? D : 8)", "#pragma unroll")]


def _card() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} | {smi}", flush=True)


def _helpers():
    """bench_mlp.py's device timing and launch split, from this checkout."""
    sys.path.insert(0, str(ROOT))
    from attention_models_torch.bench_mlp import _device_ms, _launch_split
    return _device_ms, _launch_split


def _operands(gen, n, k, d, dtype):
    from attention_models_torch.ops.codebook import l2_normalize
    z = l2_normalize(torch.randn(n, d, generator=gen, device="cuda"))
    c = l2_normalize(torch.randn(k, d, generator=gen, device="cuda"))
    return z.to(dtype), c.to(dtype)


def _chains(z, codes):
    """The two library chains of the same function on fp32 operands."""
    def cdist():
        return torch.cdist(z.float(), codes.float()).argmin(dim=1)

    def addmm():
        cf = codes.float()
        return torch.addmm(torch.sum(cf * cf, dim=-1), z.float(), cf.T,
                           alpha=-2).argmin(dim=1)
    return {"cdist+argmin": cdist, "addmm+argmin": addmm}


def _time_ms(fn, iters):
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


def _gaps(z, codes, idx, other):
    """Agreement of two index vectors and the largest plain top-2 gap where
    they differ."""
    zf, cf = z.float(), codes.float()
    dist = torch.sum(cf * cf, dim=-1)[None] - 2.0 * (zf @ cf.T)
    top2 = dist.topk(2, dim=1, largest=False).values
    differ = idx.long() != other.long()
    gap = top2[:, 1] - top2[:, 0]
    return (float((~differ).float().mean()),
            float(gap[differ].max()) if bool(differ.any()) else 0.0)


def turns(iters: int) -> None:
    _device_ms, _ = _helpers()
    from attention_models_torch.ops import _build
    from attention_models_torch.ops.codebook import (
        ANY, TILES, WGMMA, codes_plan, nearest_codes)

    DESIGNS = {WGMMA: "wgmma", TILES: "tiles", ANY: "any"}
    torch.backends.cuda.matmul.allow_tf32 = False
    _card()
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for d in (32, 8, 64, 20):
        for dtype in (torch.bfloat16, torch.float32):
            z, codes = _operands(gen, N_TOK, N_CODES, d, dtype)
            chains = _chains(z, codes)
            lib_ms = {k: _device_ms(f, iters) for k, f in chains.items()}
            name = min(lib_ms, key=lib_ms.get)
            lib = chains[name]

            def run():
                return nearest_codes(z, codes)

            k1, l1, l2, k2 = (_device_ms(run, iters), _device_ms(lib, iters),
                              _device_ms(lib, iters), _device_ms(run, iters))
            b1, b2 = _time_ms(run, iters), _time_ms(run, iters)
            kern, lb = (k1 + k2) / 2, (l1 + l2) / 2
            bound = 2 * N_TOK * N_CODES * d / PEAK[dtype] * 1e3
            agree, gap = _gaps(z, codes, run(), lib())
            design = DESIGNS[codes_plan(N_TOK, N_CODES, d, dtype).design]
            print(f"[turns] 4 ({N_TOK},{d}) x {N_CODES} {str(dtype)[6:]} "
                  f"({design}): kernel {k1:.4f} / {k2:.4f} ms, {name} "
                  f"{l1:.4f} / {l2:.4f} ms (chains alone: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in lib_ms.items())
                  + f"), kernel/library {kern / lb:.3f}; back to back "
                  f"{b1:.4f} / {b2:.4f} ms; bound {bound:.4f} ms "
                  f"({100 * bound / kern:.1f} % of it); agreement with the "
                  f"chain {agree:.6f}, largest gap where they differ "
                  f"{gap:.3e}", flush=True)
            del z, codes


def _bind(lib: ctypes.CDLL, parent: bool = False) -> ctypes.CDLL:
    from attention_models_torch.ops import _build
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.amt_nearest_codes.argtypes = (
        [P] * 5 + [I] * 5 + [P] if parent
        else _build._SIGNATURES["amt_nearest_codes"])
    lib.amt_nearest_codes.restype = ctypes.c_int
    return lib


def _caller(lib, z, codes, parent=False):
    """A call of ``lib``'s amt_nearest_codes as the wrapper makes it (the
    parent's entry: 512-code slices, no work scratch)."""
    from attention_models_torch.ops import _build
    from attention_models_torch.ops.codebook import codes_plan
    n, d = z.shape
    k = codes.shape[0]
    plan = codes_plan(n, k, d, z.dtype)
    parts = n * -(-k // 512) if parent else plan.parts
    part_d = torch.empty(parts, dtype=torch.float32, device="cuda")
    part_i = torch.empty(parts, dtype=torch.int32, device="cuda")
    work = torch.empty(plan.work, dtype=torch.float32, device="cuda")
    out = torch.empty(n, dtype=torch.int32, device="cuda")
    code = _build.DTYPE_CODES[z.dtype]

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        head = (z.data_ptr(), codes.data_ptr(), part_d.data_ptr(),
                part_i.data_ptr(), out.data_ptr(), n, k, d)
        err = (lib.amt_nearest_codes(*head, 512, code, stream) if parent else
               lib.amt_nearest_codes(*head, plan.split, code,
                                     work.data_ptr(), stream))
        if err:
            raise RuntimeError(f"amt_nearest_codes: CUDA error {err}")
        return out
    return call


def _variant_library(name: str, edits) -> ctypes.CDLL:
    """csrc/codebook.cu of this checkout with each (old, new) edit, built
    alone (with errors.cu) into build/codebook_variants/<name>."""
    from attention_models_torch.ops import _build
    out = ROOT / "build" / "codebook_variants" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(ROOT / "attention_models_torch" / "csrc", out)
    text = (out / "codebook.cu").read_text()
    for old, new in edits:
        if old not in text:
            raise ValueError(f"csrc/codebook.cu has no {old!r}")
        text = text.replace(old, new)
    (out / "codebook.cu").write_text(text)
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.ARCH, *_build.FLAGS, "-shared",
         str(out / "codebook.cu"), str(out / "errors.cu"), "-o",
         str(out / "lib.so")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    return _bind(ctypes.CDLL(str(out / "lib.so")))


def _in_turns(_device_ms, a, b, iters):
    a1, b1, b2, a2 = (_device_ms(a, iters), _device_ms(b, iters),
                      _device_ms(b, iters), _device_ms(a, iters))
    return (a1 + a2) / 2, (b1 + b2) / 2, (a1, b1, b2, a2)


def split(iters: int) -> None:
    _device_ms, _launch_split = _helpers()
    from attention_models_torch.ops import _build
    from attention_models_torch.ops.codebook import nearest_codes

    _card()
    this = _bind(_build.library())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        z, codes = _operands(gen, N_TOK, N_CODES, 32, dtype)
        parts = _launch_split(lambda: nearest_codes(z, codes))
        print(f"[split] 4 ({N_TOK},32) x {N_CODES} {str(dtype)[6:]}: device "
              f"time a call {sum(us for us, _ in parts.values()):.1f} us; "
              + "; ".join(f"{k} {us:.1f} us x {c:g}" for k, (us, c) in
                          sorted(parts.items(), key=lambda kv: -kv[1][0])),
              flush=True)
        cut = _variant_library(f"cut_{str(dtype)[6:]}", CUT_EPILOGUE[dtype])
        ship, diag, raw = _in_turns(_device_ms, _caller(this, z, codes),
                                    _caller(cut, z, codes), iters)
        what = ("no epilogue: the wgmma products and the ring" if
                dtype == torch.bfloat16 else
                "a running min without its index: the FMA tiles")
        print(f"[split] 4 {str(dtype)[6:]} whole call {ship:.4f} ms against "
              f"{diag:.4f} ms with the epilogue cut ({what}; turns "
              + " / ".join(f"{v:.4f}" for v in raw)
              + f"): the epilogue {1e3 * (ship - diag):.1f} us a call",
              flush=True)
        del z, codes


def variants(iters: int) -> None:
    _device_ms, _ = _helpers()
    from attention_models_torch.ops import _build

    _card()
    this = _bind(_build.library())
    wide = _variant_library("rows_128", WIDE_ROWS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for d in (32, 16, 8):
        z, codes = _operands(gen, N_TOK, N_CODES, d, torch.bfloat16)
        ship, other = _caller(this, z, codes), _caller(wide, z, codes)
        same = torch.equal(ship().clone(), other())
        a, b, raw = _in_turns(_device_ms, ship, other, iters)
        print(f"[rows] 4 ({N_TOK},{d}) x {N_CODES} bf16: rows of "
              f"{max(32, 2 * d)} bytes {a:.4f} ms against the 128-byte K "
              f"slice {b:.4f} ms (turns "
              + " / ".join(f"{v:.4f}" for v in raw)
              + f"), ratio {a / b:.3f}; same indices {same}", flush=True)
        if not same:
            raise AssertionError("the 128-byte rows gave other indices")
    whole = _variant_library("whole_64", WHOLE_64)
    torch.backends.cuda.matmul.allow_tf32 = False
    z, codes = _operands(gen, N_TOK, N_CODES, 64, torch.float32)
    ship, other = _caller(this, z, codes), _caller(whole, z, codes)
    same = torch.equal(ship().clone(), other())
    a, b, raw = _in_turns(_device_ms, ship, other, iters)
    print(f"[unroll] 4 ({N_TOK},64) x {N_CODES} fp32: the width 8 at a time "
          f"{a:.4f} ms against whole {b:.4f} ms (turns "
          + " / ".join(f"{v:.4f}" for v in raw)
          + f"), ratio {a / b:.3f}; same indices {same}", flush=True)
    if not same:
        raise AssertionError("the whole unroll gave other indices")


def _library_of(root: Path) -> ctypes.CDLL:
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.'); from "
         "attention_models_torch.ops import _build; print(_build.build())"],
        cwd=root, capture_output=True, text=True, check=True)
    return ctypes.CDLL(out.stdout.strip().splitlines()[-1])


def bits(root: Path, iters: int) -> None:
    _device_ms, _ = _helpers()
    from attention_models_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _card()
    this, other = _bind(_build.library()), _bind(_library_of(root), True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    same_all = True
    for dtype, widths in ((torch.float32, (8, 32, 64)),
                          (torch.bfloat16, (8, 16, 32, 64))):
        for d in widths:
            z, codes = _operands(gen, N_TOK, N_CODES, d, dtype)
            mine, theirs = _caller(this, z, codes), _caller(other, z, codes,
                                                            parent=True)
            got, want = mine().clone(), theirs().clone()
            agree, gap = _gaps(z, codes, got, want)
            p_ms, t_ms, raw = _in_turns(_device_ms, theirs, mine, iters)
            same = torch.equal(got, want)
            if dtype == torch.float32:
                same_all &= same
            print(f"[bits] 4 ({N_TOK},{d}) x {N_CODES} {str(dtype)[6:]}: "
                  f"indices equal to {root.name}'s {same} (agreement "
                  f"{agree:.6f}, largest plain top-2 gap where they differ "
                  f"{gap:.3e}); {root.name} {p_ms:.4f} ms, this {t_ms:.4f} "
                  f"ms in turns ("
                  + " / ".join(f"{v:.4f}" for v in raw) + ")", flush=True)
            del z, codes
    if not same_all:
        raise AssertionError(f"fp32 indices differ from {root}'s")
    print(f"[bits] fp32 indices equal to {root.name}'s at widths 8, 32, 64",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="turns",
                    choices=("turns", "split", "variants", "bits"))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="bits: the checkout to compare with")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_codebook: needs a CUDA card", file=sys.stderr)
        return 2
    if args.mode == "turns":
        turns(args.iters)
    elif args.mode == "split":
        split(args.iters)
    elif args.mode == "variants":
        variants(args.iters)
    else:
        bits(args.root.resolve(), args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
