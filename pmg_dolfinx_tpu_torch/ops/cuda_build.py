"""Build a kernel source with ``nvcc``, load it through `ctypes`, and pass
it checked tensors.

The one build-and-load path of the port's hand-written CUDA kernels
(`ops/kron_blocked.py`, `ops/lattice_blocked.py`), with their shared
operand check and ctypes argument helpers: each source compiles
for ``sm_90a`` into a shared library with a plain C interface, once per
hash of the source, the headers of ``csrc/`` (on the include path, so a
copy of a source built elsewhere finds them) and the flags, under
``build/kernels/`` at the root of the checkout. Nothing here runs at
import time, and nothing falls back: no device, no ``nvcc`` or a failed
build raises RuntimeError.
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc():
    """``nvcc`` on the PATH or under ``/usr/local/cuda/bin``, else None."""
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    return nvcc


def build_and_load(src, name, find=find_nvcc, defines=()):
    """Compile ``src`` (once per hash of the source, the headers of
    ``CSRC`` and the flags) and load it.

    Returns ``(library, build_log)``; the log is the compiler's output
    (``-Xptxas -v``: registers, shared memory, spills) of a build made by
    this call, or "" when the library was already built. ``name`` prefixes
    the library file and the error messages; ``find`` locates ``nvcc``;
    ``defines`` are extra ``NAME=VALUE`` macros (``-D``), part of the hash,
    so one source can build several libraries side by side.
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"the {name} CUDA kernels need a CUDA device; "
            "torch.cuda.is_available() is False")
    nvcc = find()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): cannot build "
            f"the {name} CUDA kernels from {src}")
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    code = Path(src).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(code + " ".join(flags).encode()).hexdigest()
    so = BUILD_DIR / f"{name}_{digest[:16]}.so"
    log = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run([nvcc, *flags, f"-I{CSRC}", "-o", str(tmp),
                               str(src)],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                f"{log}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so)), log


def check_operand(name, t, shape, device, dtype=torch.float32):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: the operand contract of every kernel wrapper."""
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"{name} must be a tensor on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t):
    """A tensor's device pointer as a ctypes argument."""
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t):
    """The current CUDA stream of ``t``'s device as a ctypes argument."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def on_device(t):
    """The device context of a launch on ``t``: none when its device is
    already the current one (a context costs a few microseconds a launch)."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)
