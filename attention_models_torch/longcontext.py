"""The long-context workload: causal flash attention at 4k, 8k and 16k tokens.

The port's counterpart of the JAX package's single-chip long-context proof
(``bench.py::_flash_longcontext_bench``): b 1, h 8, d 64, bf16, causal, at
t 4096, 8192 and 16384, through ``ops.flash_attention.flash_attention``
(kernel 16 forward, kernels 17 and 18 backward), q, k and v drawn from
``numpy.random.RandomState(0)`` at each length as there. It times the
forward and the forward + backward of ``out.float().sum()`` and reads the
peak memory above the inputs: the kernels hold no (t, t) score matrix,
which at t 16384 would take 8 GiB in fp32.

    from attention_models_torch.longcontext import longcontext
    rows = longcontext()   # on the card; device="cpu" runs the plain path
"""

from __future__ import annotations

import time

import numpy as np
import torch

from attention_models_torch.ops.dispatch import resolve_device
from attention_models_torch.ops.flash_attention import flash_attention

SEQ_LENS = (4096, 8192, 16384)
B, H, D = 1, 8, 64  # the JAX bench's batch, heads and head width


def make_inputs(t: int, device=None) -> tuple[torch.Tensor, ...]:
    """q, k, v (B, H, t, D) in bf16 from ``RandomState(0)``, in that order
    (the JAX bench's draws)."""
    rs = np.random.RandomState(0)
    dev = resolve_device(device)
    return tuple(torch.from_numpy(rs.randn(B, H, t, D)).to(
        device=dev, dtype=torch.bfloat16) for _ in range(3))


def _time_ms(fn, iters: int, dev: torch.device) -> float:
    """Mean ms per call after one warm-up call: CUDA events on the card,
    the host clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def longcontext(seq_lens=SEQ_LENS, *, fwd_iters: int = 10,
                grad_iters: int = 5, device=None) -> list[dict]:
    """One row a length: ``fwd_ms`` and ``fwd_bwd_ms`` per call, the number
    of each call made (``fwd_calls``, ``fwd_bwd_calls``: the warm-up, the
    timed ones and one for the peak), and ``peak_bytes``, the most memory
    allocated above the inputs during a forward + backward (None on the
    CPU)."""
    dev = resolve_device(device)
    rows = []
    for t in seq_lens:
        q, k, v = make_inputs(t, device=dev)
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]

        def fwd():
            with torch.no_grad():
                return flash_attention(q, k, v, causal=True)

        def fwd_bwd():
            out = flash_attention(*leaves, causal=True)
            return torch.autograd.grad(out.float().sum(), leaves)

        fwd_ms = _time_ms(fwd, fwd_iters, dev)
        grad_ms = _time_ms(fwd_bwd, grad_iters, dev)
        peak = None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            fwd_bwd()
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev) - base
        else:
            fwd_bwd()
        rows.append(dict(t=t, fwd_ms=fwd_ms, fwd_bwd_ms=grad_ms,
                         fwd_calls=fwd_iters + 1,
                         fwd_bwd_calls=grad_iters + 2, peak_bytes=peak))
    return rows
