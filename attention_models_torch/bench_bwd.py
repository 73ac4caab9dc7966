"""A/B timings of the LN-MLP backward (kernel 6), the GELU-MLP backward
(kernel 8) and the head cross-entropy backward (kernel 14) on one card.

    python attention_models_torch/bench_bwd.py [--iters N]
        Kernel 6 at the ViTVQGAN main path's (8192, 512), hidden 1368, and
        at d 768 / hidden 2048 and d 1024 / hidden 2728, kernel 8 at ViT's
        (4160, 1024), hidden 2048, and kernel 14 at MaskGIT's (8192, 768),
        vocab 8192, bf16 without a bias: first each launch's device time a
        call and launches a call (torch.profiler, 20 calls), then the
        weight gradients' split of K = n (the plan's choice against 1, 2, 4
        and 8 ranges; kernel 8 also its library chain, linear -> gelu ->
        linear forward and backward through autograd) in turns: device
        time with the launches queued behind a sleep, every variant once in
        order, then once in reverse, twice over. Every variant must stay
        within 2e-2 (relative L2) of the plain version on every output.

To time a parent commit's kernels, copy this file and bench_mlp.py into
its checkout (unpacked with git archive under build/) and run the copy:
the package is imported from the file's checkout.

Needs a Hopper card and nvcc; the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from attention_models_torch.bench_mlp import (  # noqa: E402
    _card, _device_ms, _launch_split)

SPLITS = (None, 1, 2, 4, 8)  # None: the plan's own choice


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_bwd: CUDA is not available", file=sys.stderr)
        return 2
    from attention_models_torch.ops import _build, ffn, xent
    from attention_models_torch.ops import gemm_sm90 as gemm

    _card()
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    split_k = gemm.split_k

    def use(s):
        """Plans made from now on split K into ``s`` ranges (None: the
        shipped rule)."""
        def fixed(tiles, k, slice_=gemm.GEMM_K):
            ktiles = -(-k // slice_)
            kslices = -(-ktiles // s)
            return -(-ktiles // kslices), kslices
        gemm.split_k = split_k if s is None else fixed
        # a copy of this file run in an older checkout may find no kernel-8
        # plan there (its kernel 8 then reads the same in every variant)
        for plan in (ffn._ln_mlp_bwd_plan, getattr(ffn, "_mlp_bwd_plan", None),
                     xent._xent_bwd_plan):
            if plan is not None:
                plan.cache_clear()

    def bf16(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).bfloat16()

    cases = []
    for n, d, hid in ((8192, 512, 1368), (8192, 768, 2048),
                      (8192, 1024, 2728)):
        a = (bf16(n, d), torch.randn(d, device="cuda") * 0.1 + 1,
             torch.randn(d, device="cuda") * 0.1,
             bf16(hid, d, scale=d ** -0.5), torch.randn(hid, device="cuda"),
             bf16(d, hid, scale=hid ** -0.5), bf16(n, d))
        cases.append((f"kernel 6 ({n},{d}) hid {hid}",
                      lambda a=a: ffn.fused_ln_mlp_backward(*a),
                      lambda a=a: ffn._ln_mlp_backward_reference(*a, 1e-5),
                      None))
    n, d, hid = 4160, 1024, 2048
    a8 = (bf16(n, d), bf16(hid, d, scale=d ** -0.5),
          torch.randn(hid, device="cuda") * 0.1,
          bf16(d, hid, scale=hid ** -0.5), bf16(n, d))
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (a8[0], a8[1], a8[2].bfloat16(), a8[3],
                        torch.randn(d, device="cuda").bfloat16())]

    def mlp_library():
        xl, w1l, b1l, w2l, b2l = leaves
        F = torch.nn.functional
        y = F.linear(F.gelu(F.linear(xl, w1l, b1l)), w2l, b2l)
        return torch.autograd.grad(y, leaves, a8[4])

    cases.append((f"kernel 8 ({n},{d}) hid {hid}",
                  lambda: ffn.fused_mlp_backward(*a8),
                  lambda: ffn._fused_mlp_backward_reference(*a8),
                  mlp_library))
    n, d, v = 8192, 768, 8192
    h, w = bf16(n, d), bf16(v, d, scale=d ** -0.5)
    tgt = torch.randint(0, v, (n,), generator=gen, device="cuda")
    lse = xent._head_xent_reference(h, w, tgt)[1]
    coef = torch.full((n,), 1.0 / n, device="cuda")
    cases.append((f"kernel 14 ({n},{d}) V {v}",
                  lambda: xent.head_xent_backward(h, w, tgt, lse, coef),
                  lambda: xent._head_xent_backward_reference(h, w, tgt, lse,
                                                             coef), None))
    rows = []
    for label, run, plain, library in cases:
        use(None)
        split = _launch_split(run)
        per_kernel = {k: round(us, 1) for k, (us, _) in split.items()}
        print(f"[bwd] {label} device time a call: {sum(per_kernel.values()):.1f}"
              f" us; by kernel (us a call, launches a call): " + "; ".join(
                  f"{k} {us:.1f} x {c:g}" for k, (us, c) in sorted(
                      split.items(), key=lambda kv: -kv[1][0])), flush=True)
        want = plain()
        variants = SPLITS + (("library",) if library else ())
        times = {v: [] for v in variants}
        for seq in (variants, variants[::-1], variants, variants[::-1]):
            for v in seq:
                if v == "library":
                    times[v].append(_device_ms(library, args.iters))
                    continue
                use(v)
                times[v].append(_device_ms(run, args.iters))
        if library:
            ms = sorted(times["library"])
            rows.append(dict(case=label, variant="library",
                             ms=times["library"], median_ms=(ms[1] + ms[2]) / 2))
            print(f"[bwd] {label} library: " + " / ".join(
                f"{t:.4f}" for t in times["library"]) + f" ms (median "
                f"{rows[-1]['median_ms']:.4f})", flush=True)
        for v in SPLITS:
            use(v)
            got = run()
            err = max(_rel(a, b) for a, b in zip(got, want) if b is not None)
            if not err <= 2e-2:
                raise AssertionError(f"{label} {v}: rel_l2 {err}")
            ms = sorted(times[v])
            name = "plan" if v is None else f"{v} ranges"
            rows.append(dict(case=label, variant=name, ms=times[v],
                             median_ms=(ms[1] + ms[2]) / 2, rel_l2=err))
            print(f"[bwd] {label} {name}: " + " / ".join(
                f"{t:.4f}" for t in times[v]) + f" ms (median "
                f"{rows[-1]['median_ms']:.4f}), rel_l2 {err:.2e}", flush=True)
        rows.append(dict(case=label, per_kernel_us=per_kernel))
    use(None)
    print(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
