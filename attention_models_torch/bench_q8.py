"""A/B timings of the W8A8 wide FFN (kernel 20) and the LayerNorm (kernel 3)
on one card.

    python attention_models_torch/bench_q8.py [turns] [--iters N]
        Kernel 20 in bf16 and fp32 (TF32 off) at Muse's shape (16384 rows,
        d 1024, inner 4096) and at inner 8704 (520 rows, d 768), and kernel
        3 at chip_smoke.py's shapes, each against its PyTorch chain in turns
        (device time with the launches queued behind a sleep: kernel,
        library, library, kernel), beside the bound; then each of kernel
        20's three launches' device time (torch.profiler, 20 calls).
    python attention_models_torch/bench_q8.py bits --root R
        Builds the kernels' library of the checkout at R (the parent:
        unpack it with git archive under build/) beside this one's and
        requires kernel 3 to give R's bits at every shape above, and kernel
        20's down-projection to give R's bits at Muse's shape on every row
        whose int8 codes and scale the two libraries' row passes agree on
        (fp32: every row).
    python attention_models_torch/bench_q8.py paths [--root R]
        Prints one JSON line for the checkout at R (default: this one):
        Muse's int8_wide generate (cfg/muse.yaml as R's chip_smoke.py builds
        it, bf16, 8 prompts, 18 steps, approx top-k) through muse_service,
        ms/step over 5 generates after a warm-up, and the card's busy time
        of one generate by kernel (torch.profiler); then MaskGIT's
        unconditional generate (cfg/maskgit.yaml, bf16, batch 8, 18 steps,
        approx top-k, as chip_smoke.py's phase 8), the other path that
        runs kernel 3 at every layer, ms/step the same way. To compare two
        commits,
        run it at the parent (unpacked under build/) and at this checkout
        in turns, parent, change, change, parent, in one call; run it as a
        file, so the package is imported from R.

Needs a Hopper card and nvcc; the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
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


def _rand(gen, *shape, dtype=torch.float32, scale=1.0, shift=0.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale
            + shift).to(dtype)


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
    for rows, d, dtype, beta in LN_SHAPES:
        x = _rand(gen, rows, d, dtype=dtype, scale=2.0, shift=0.5)
        g = _rand(gen, d, scale=0.1, shift=1.0)
        b = _rand(gen, d, scale=0.1) if beta else None
        gl, bl = g.to(dtype), (b.to(dtype) if beta else None)
        nbytes = 2 * x.numel() * x.element_size() + 4 * d * (1 + beta)
        in_turns(f"3 ({rows},{d}){'' if beta else ' no beta'} "
                 f"{str(dtype)[6:]}", lambda: layernorm(x, g, b),
                 lambda: F.layer_norm(x, (d,), gl, bl), nbytes / HBM * 1e3)


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

    _card()
    this, other = _build.library(), _library_of(root)
    sig = _build._SIGNATURES
    other.amt_layernorm.argtypes = sig["amt_layernorm"]
    # the parent's kernel 20 entry takes no plan
    other.amt_ffn_q8wide.argtypes = sig["amt_ffn_q8wide"][1:]
    for fn in ("amt_layernorm", "amt_ffn_q8wide"):
        getattr(other, fn).restype = ctypes.c_int
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    same_all = True
    for rows, d, dtype, beta in LN_SHAPES:
        x = _rand(gen, rows, d, dtype=dtype, scale=2.0, shift=0.5)
        g = _rand(gen, d, scale=0.1, shift=1.0)
        b = _rand(gen, d, scale=0.1) if beta else None
        ys = [torch.empty_like(x), torch.empty_like(x)]
        for lib, y in zip((this, other), ys):
            err = lib.amt_layernorm(x.data_ptr(), g.data_ptr(),
                                    b.data_ptr() if beta else None,
                                    y.data_ptr(), rows, d, 1e-5,
                                    _build.DTYPE_CODES[dtype], stream)
            if err:
                raise RuntimeError(f"amt_layernorm: CUDA error {err}")
        torch.cuda.synchronize()
        same = torch.equal(ys[0], ys[1])
        differ = int((ys[0] != ys[1]).sum())
        same_all &= same
        print(f"[bits] 3 ({rows},{d}){'' if beta else ' no beta'} "
              f"{str(dtype)[6:]}: bit-equal to R's {same} ({differ} of "
              f"{x.numel()} values differ)", flush=True)
    n, d, inner = MUSE  # the parent refuses inner above 4096
    for dtype in (torch.bfloat16, torch.float32):
        x, w1, gam, q2 = _q8wide_operands(gen, n, d, inner, dtype)
        w1c = w1.to(dtype).contiguous()
        plan = q.q8wide_plan(n, d, inner)
        outs = []
        for lib in (this, other):
            g = torch.empty(n * plan.g_pitch, device="cuda")
            yq = torch.empty(n, inner, dtype=torch.int8, device="cuda")
            sy = torch.empty(n, device="cuda")
            out = torch.empty_like(x)
            ptrs = (x.data_ptr(), w1c.data_ptr(), gam.data_ptr(),
                    q2.q.data_ptr(), q2.scale.data_ptr(), g.data_ptr(),
                    yq.data_ptr(), sy.data_ptr(), out.data_ptr(), n, d,
                    inner, 1e-5, _build.DTYPE_CODES[dtype], stream)
            err = (lib.amt_ffn_q8wide(plan.c_array(), *ptrs)
                   if lib is this else lib.amt_ffn_q8wide(*ptrs))
            if err:
                raise RuntimeError(f"amt_ffn_q8wide: CUDA error {err}")
            outs.append((yq, sy, out))
        torch.cuda.synchronize()
        (yq0, sy0, o0), (yq1, sy1, o1) = outs
        rows_same = (yq0 == yq1).all(dim=1) & (sy0 == sy1)
        same = torch.equal(o0[rows_same], o1[rows_same])
        if dtype == torch.float32:
            same &= bool(rows_same.all())
        same_all &= same
        print(f"[bits] 20 ({n},{d}) inner {inner} {str(dtype)[6:]}: the "
              f"down-projection bit-equal to R's on the {int(rows_same.sum())}"
              f" of {n} rows with equal codes and scales: {same}",
              flush=True)
    if not same_all:
        raise AssertionError("bits differ from R's")


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
    mm = build_model(cs.muse_config("bf16", "int8_wide"), device=dev).eval()
    svc = muse_service(mm, timesteps=18, approx_topk=True)
    text_ids, seeds = tokenize(cs.MUSE_PROMPTS), list(range(8))

    def generate_s():
        torch.cuda.synchronize()
        t = time.perf_counter()
        svc(text_ids, seeds)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    generate_s()
    times = [generate_s() for _ in range(5)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        svc(text_ids, seeds)
        torch.cuda.synchronize()
    busy = {}
    for e in prof.key_averages():
        t = (getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA and t > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0][-60:]
            busy[name] = busy.get(name, 0.0) + t / 1e3
    total = sum(busy.values())
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
    times.sort()
    res = dict(root=str(root), muse_int8_wide_ms_per_step=[
        t / 18 * 1e3 for t in times], median_ms_per_step=times[2] / 18 * 1e3,
        busy_ms=total, top=[(k, v, v / total) for k, v in top])
    del mm, svc
    torch.cuda.empty_cache()
    mg = build_model(cs.maskgit_config("bf16"), device=dev).eval()
    svc = maskgit_service(mg, timesteps=18, num_masked=1024, approx_topk=True)
    seeds = list(range(8))

    def maskgit_s():
        torch.cuda.synchronize()
        t = time.perf_counter()
        svc({}, seeds)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    maskgit_s()
    times = sorted(maskgit_s() for _ in range(5))
    res["maskgit_ms_per_step"] = [t / 18 * 1e3 for t in times]
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
