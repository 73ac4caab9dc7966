"""Device resolution and the kernel/plain split.

Counterpart of ``attention_models_tpu/ops/dispatch.py``. There a kernel runs
when the backend is a TPU; here a wrapper runs its kernel when its tensor lies
on a CUDA device and its plain PyTorch version when the tensor lies on the
CPU. There is no fallback from one to the other: a CUDA tensor the kernel
cannot take raises.

Entry points take ``device=None`` to mean the card, and raise without one;
the CPU is used only when the caller asks for it (``device="cpu"``).
"""

from __future__ import annotations

import math

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def is_kernel_path(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel or plain path for device {t.device}")


def needs_grad(*tensors: torch.Tensor | None) -> bool:
    """True when autograd records and some tensor requires a gradient: the
    kernel wrappers then go through their ``torch.autograd.Function``;
    otherwise (serving, ``no_grad``) they launch the forward kernel
    directly, without the Function's per-call host cost. ``chip_smoke.py``
    measures that cost on the serving path (Function against direct,
    alternating pairs in one process)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def rows_lane_tileable(shape: tuple, d: int) -> bool:
    """The JAX package's row-tiled kernel shape rule: d a multiple of 128,
    the flattened leading rows a nonzero multiple of 8."""
    n = math.prod(shape[:-1]) if len(shape) > 1 else 1
    return d % 128 == 0 and n % 8 == 0 and n >= 8


def require_hopper() -> None:
    """The kernels are built for sm_90a (H100/H200); refuse other cards."""
    major, minor = torch.cuda.get_device_capability()
    if (major, minor) != (9, 0):
        raise RuntimeError(
            f"the port's kernels need an sm_90 (Hopper) card; "
            f"{torch.cuda.get_device_name()} is sm_{major}{minor}"
        )


def check_tensor(t: torch.Tensor, name: str, dtypes: tuple,
                 ndim: int | None = None,
                 device: torch.device | None = None) -> None:
    """Dtype, rank, device and contiguity checks shared by the kernel
    wrappers."""
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
