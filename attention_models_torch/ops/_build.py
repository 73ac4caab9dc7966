"""Builds the port's CUDA kernels and binds them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``, and the objects are linked into one shared library
with a plain C interface under ``build/attention_models_torch/`` in the
checkout. Each compile runs ptxas verbose and keeps its output beside the
object (``ptxas_report`` reads a kernel's registers, shared memory and
spill bytes from it). The library's name carries a hash of the sources and
flags, so an edit rebuilds and an unchanged tree reuses the last build. The
build runs at the first kernel launch of a process (or from ``build()``);
nothing here runs at import.

Each C entry point takes pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; ``launch`` raises on a
nonzero code, so a refused launch is never silent.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

from attention_models_torch.ops.dispatch import require_hopper

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "attention_models_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_S = ctypes.POINTER(ctypes.c_int64)  # an int64 array: strides, a host plan
_SIGNATURES = {
    "amt_layernorm": [_P, _P, _P, _P, ctypes.c_int64, _I, _F, _I, _P],
    "amt_nearest_codes": [_P] * 5 + [_I] * 5 + [_P, _P],
    "amt_flash_fwd_kv": [_P] * 4 + [_S] + [_I] * 5 + [_F, _I, _I, _P],
    "amt_ln_mlp": [_P] * 11 + [_S] + [_I, _I, _I, _F, _I, _P],
    "amt_flash_bwd_kv": [_P] * 7 + [_S] + [_I] * 5 + [_F, _I, _I, _P],
    "amt_flash_fwd": [_P] * 5 + [_S, _S] + [_I] * 5 + [_F, _I, _I, _P],
    "amt_flash_bwd_dkv": [_P] * 8 + [_S, _S] + [_I] * 5 + [_F, _I, _I, _P],
    "amt_flash_bwd_dq": [_P] * 7 + [_S, _S] + [_I] * 5 + [_F, _I, _I, _P],
    "amt_ln_mlp_bwd": [_S] + [_P] * 20 + [_I, _I, _I, _F, _P],
    "amt_ffn": [_S] + [_P] * 8 + [_I, _I, _I, _F, _I, _P],
    "amt_ffn_bwd": [_S] + [_P] * 15 + [_I, _I, _I, _F, _I, _P],
    "amt_head_xent_fwd": [_P] * 7 + [_S] + [_I] * 4 + [_P],
    "amt_head_xent_bwd": [_P] * 12 + [_S] + [_I] * 4 + [_P],
    "amt_sample_epilogue": [_P] * 4 + [_I, _I, _P, _P, _I, _I, _I, _I, _F,
                                       _F, _I, _P],
    "amt_ffn_q8": [_S] + [_P] * 12 + [_I, _I, _I, _F, _I, _P],
    "amt_ffn_q8wide": [_S] + [_P] * 9 + [_I, _I, _I, _F, _I, _P],
    "amt_ln_mlp_q8": [_S] + [_P] * 16 + [_I] * 3 + [_F, _I, _P],
    "amt_mlp": [_P] * 9 + [_S] + [_I] * 4 + [_P],
    "amt_tile_product": [_S] + [_P] * 4 + [_I] * 5 + [_P],
    "amt_tile_product_f32": [_P, _I, _P, _I, _P] + [_I] * 5 + [_P],
    "amt_tile_product_s8": [_S] + [_P] * 5 + [_I] * 4 + [_P],
    "amt_mlp_bwd": [_S] + [_P] * 16 + [_I, _I, _I, _P],
}

_lib: ctypes.CDLL | None = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")


def _tag(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the kernels' library."""
    sources = sorted(CSRC.glob("*.cu"))
    tag = _tag(sources + sorted(CSRC.glob("*.cuh")))
    out = BUILD_DIR / f"libamt_kernels_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        cmd = [nvcc, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, obj, proc))
    failed = []
    for src, obj, proc in jobs:
        log, _ = proc.communicate()
        obj.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", *(str(o) for _, o, _ in jobs), "-o", str(tmp)],
        capture_output=True, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, out)
    return out


def ptxas_report(source: str, kernel: str) -> list[dict]:
    """ptxas's figures for each instantiation of ``kernel`` in
    ``csrc/<source>.cu`` from the last build's log: name (mangled),
    registers, shared memory (static bytes), spill stores and loads."""
    tag = build().name.split("_")[-1].split(".")[0]
    log = (BUILD_DIR / f"{source}_{tag}.log").read_text()
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = dict(name=m.group(1)) if kernel in m.group(1) else None
            if cur is not None:
                rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(m.group(1)) if m else 0
    return rows


def library() -> ctypes.CDLL:
    """The loaded kernels' library, built at the first call."""
    global _lib
    if _lib is None:
        require_hopper()
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.amt_error_string.argtypes = [ctypes.c_int]
        lib.amt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, *args) -> None:
    """Call C entry ``name`` and raise if it reports a CUDA error."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.amt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
