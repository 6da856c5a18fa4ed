"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own
shared library, compiled by ``nvcc`` for Hopper (``sm_90a``) at first use
and loaded with ``ctypes``.  The libraries go under
``build/tsgu_torch/<hash>/`` at the repository root, keyed by a hash of
every source and the flags, so an edited source builds anew and an
unchanged one is loaded as it is.  All sources compile at once, one
``nvcc`` process each.

Every C entry takes its pointers and the CUDA stream as ``void*`` and
its sizes as ``int64``, launches on that stream, and returns
``cudaGetLastError()``; :func:`launch` raises when that is not 0.

Nothing here runs when the package is imported: the first kernel launch
on a CUDA tensor calls :func:`libraries`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "tsgu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
KERNELS = ("dia_spmm", "dia_sddmm", "gather", "chunk_spmm", "chunk_sddmm",
           "chunk_spmv", "tri_dia", "chunk_lse", "chunk_bwd_fused")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("cannot build the CUDA kernels: nvcc was not found "
                       "on PATH or under $CUDA_HOME/bin")


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile every kernel that is not built yet; returns
    ``{"dir": ..., "seconds": ..., "logs": {name: ptxas output}}``."""
    out_dir = BUILD_ROOT / _source_key()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    todo = [k for k in KERNELS if not (out_dir / f"lib{k}.so").exists()]
    nvcc = _nvcc() if todo else None
    procs = {}
    for k in todo:
        tmp = out_dir / f"lib{k}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{k}.cu")]
        procs[k] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for k, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{k}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{k}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out_dir / f"lib{k}.so")
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    logs = {k: (out_dir / f"{k}.log").read_text() for k in KERNELS
            if (out_dir / f"{k}.log").exists()}
    return {"dir": str(out_dir), "seconds": time.perf_counter() - t0,
            "logs": logs}


@functools.lru_cache(maxsize=None)
def libraries() -> dict:
    """``{name: ctypes.CDLL}`` of every kernel, built on first call."""
    out_dir = Path(build()["dir"])
    return {k: ctypes.CDLL(str(out_dir / f"lib{k}.so")) for k in KERNELS}


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float64: "f64"}


def suffix(dtype: torch.dtype) -> str:
    """The C entries' name suffix of a storage dtype."""
    return _SUFFIX[dtype]


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the kernels (and their plain versions) accumulate in:
    float32 for bfloat16 and float16, the type itself otherwise."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) \
        else dtype


def cuda_operands(name: str, floats, ints) -> str:
    """Check a kernel's operands and return its dtype suffix.

    ``floats`` must share one dtype of float32, bfloat16 or float64;
    ``ints`` must be int64; all must be contiguous and on one CUDA device.
    Raises ValueError otherwise: a kernel wrapper never falls back to
    its plain version for a tensor that is not on the CPU.
    """
    tensors = tuple(floats) + tuple(ints)
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: needs all tensors on one CUDA device "
                         f"(or all on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    dtype = floats[0].dtype
    if dtype not in _SUFFIX or any(t.dtype != dtype for t in floats):
        raise ValueError(f"{name}: the CUDA kernel takes one of float32, "
                         f"bfloat16 or float64, got "
                         f"{[str(t.dtype) for t in floats]}")
    if any(t.dtype != torch.int64 for t in ints):
        raise ValueError(f"{name}: index tensors must be int64, got "
                         f"{[str(t.dtype) for t in ints]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel needs contiguous tensors")
    return _SUFFIX[dtype]


@functools.lru_cache(maxsize=None)
def _entry(lib: ctypes.CDLL, entry: str, pointers: tuple):
    """C entry ``entry`` of ``lib``, typed once for arguments that are
    pointers (True) or int64 (False), then the stream."""
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p if ptr else ctypes.c_int64
                   for ptr in pointers] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(kernel: str, entry: str, *args) -> None:
    """Call C entry ``entry`` of ``kernel``'s library with ``args``
    (tensors pass their data pointer, ints pass as int64) on the current
    CUDA stream; raises if the launch reports a CUDA error."""
    pointers = tuple(isinstance(a, torch.Tensor) for a in args)
    fn = _entry(libraries()[kernel], entry, pointers)
    c_args = [a.data_ptr() if ptr else int(a)
              for a, ptr in zip(args, pointers)]
    dev = next(a.device for a, ptr in zip(args, pointers) if ptr)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*c_args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: kernel launch failed with CUDA error "
                           f"{rc}")
