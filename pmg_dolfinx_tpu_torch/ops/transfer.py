"""Fused per-axis p-transfers: a hand-written CUDA kernel pair and its
plain torch version.

Port of `pmg_dolfinx_tpu.ops.pallas_transfer`. A p-transfer is the triple
Kronecker action

    y[a, b, c] = sum_xyz Mx[a, x] My[b, y] MzT[z, c] x3[x, y, z]

with ``(Mx, My, MzT)`` from `transfer_mats`: ``(Ix, Iy, Iz^T)`` to prolong
(coarse -> fine), ``(Ix^T, Iy^T, Iz)`` to restrict (fine -> coarse), the
``I`` being the per-axis interpolation matrices of
`ops.lattice.axis_interpolation_matrix`.

- `blocked_transfer(x3, Mx, My, MzT)` — the entry point. On a CPU tensor
  it runs `plain_transfer`; on a CUDA tensor it launches the two kernels
  of `csrc/transfer.cu` or raises (no fallback): `transfer_x` (#10,
  ``_kernel_tx``) writes ``t = Mx ._x x3``, the only intermediate that
  reaches device memory, and `transfer_yz` (#11, ``_kernel_tyz``) forms
  ``My t_a MzT`` for each ``a``-slab from the ``t`` rows it stages in
  shared memory.
- The kernels sum each row only over its nonzero range ``[lo, hi)``:
  `nonzero_ranges` finds it on the device, from the matrix itself, and
  caches it on the matrix (recomputed only after an in-place write), so
  the result is the dense product's for any matrix the caller passes.
- `plain_transfer` — the three einsums in the JAX package's x, y, z order
  (its emulation path); `plain_transfer_x` / `plain_transfer_yz` are the
  two kernels' halves of it.

The kernels are built with ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/`` (`ops.cuda_build`) and bound with `ctypes`. `LAUNCHES`
counts every kernel launch.

Not ported: the TPU kernels' slab sizes ``by``/``bx`` (the CUDA kernels
fix their own tiles) and ``interpret``.
"""

import ctypes
from pathlib import Path

import torch

from .cuda_build import build_and_load
from .cuda_build import check_operand as _check
from .cuda_build import find_nvcc as _find_nvcc
from .cuda_build import ptr as _ptr
from .cuda_build import stream_of

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "transfer.cu"

# Kernel launches since the last reset: kernel name -> count. Raised only
# where a wrapper launches its kernel.
LAUNCHES = {"transfer_x": 0, "transfer_yz": 0}

# The loaded library and the compiler's output of the build that made it.
_lib = None
BUILD_LOG = ""


def transfer_mats(I1s, direction, dtype=torch.float32):
    """``(Mx, My, MzT)`` for `blocked_transfer` from the per-axis
    interpolation matrices ``I1s = (Ix, Iy, Iz)`` (fine x coarse):
    ``direction`` 'prolong' gives ``(Ix, Iy, Iz^T)``, 'restrict' ``(Ix^T,
    Iy^T, Iz)``. Contiguous copies in ``dtype`` on the matrices' device,
    formed once by the caller that keeps them (the V-cycle does)."""
    Ix, Iy, Iz = (torch.as_tensor(I).to(dtype) for I in I1s)
    if direction == "prolong":
        mats = Ix, Iy, Iz.T
    elif direction == "restrict":
        mats = Ix.T, Iy.T, Iz
    else:
        raise ValueError(f"unknown direction {direction!r}")
    return tuple(M.contiguous() for M in mats)


def nonzero_ranges(M, axis=0):
    """``[lo, hi)`` of the nonzeros of each row (``axis=0``) or column
    (``axis=1``) of the 2D ``M``, as a ``(2, n)`` int32 tensor on ``M``'s
    device (``lo = hi = 0`` for an all-zero line). Computed on the device
    without a host read, once per tensor: the result is cached on ``M``
    with its version counter, so an in-place write recomputes it."""
    key = "_pmg_nz_rows" if axis == 0 else "_pmg_nz_cols"
    hit = getattr(M, key, None)
    if hit is not None and hit[0] == M._version:
        return hit[1]
    nz = (M != 0) if axis == 0 else (M != 0).T
    K = nz.shape[1]
    idx = torch.arange(K, device=M.device)
    lo = torch.where(nz, idx, K).amin(dim=1)
    hi = torch.where(nz, idx + 1, 0).amax(dim=1)
    lo = torch.minimum(lo, hi)          # all-zero lines: [0, 0)
    ranges = torch.stack([lo, hi]).to(torch.int32).contiguous()
    setattr(M, key, (M._version, ranges))
    return ranges


# --- plain torch versions -----------------------------------------------------

def plain_transfer_x(x3, Mx):
    """Kernel #10's function: ``t[a, y, z] = sum_x Mx[a, x] x3[x, y, z]``."""
    return torch.einsum("ax,xyz->ayz", Mx, x3)


def plain_transfer_yz(t, My, MzT):
    """Kernel #11's function: ``out[a] = My @ t[a] @ MzT`` (y, then z)."""
    t = torch.einsum("by,xyz->xbz", My, t)
    return torch.einsum("xyz,zc->xyc", t, MzT)


def plain_transfer(x3, Mx, My, MzT):
    """`blocked_transfer`'s function: three einsums in x, y, z order."""
    return plain_transfer_yz(plain_transfer_x(x3, Mx), My, MzT)


# --- CUDA kernels -------------------------------------------------------------

def load_kernels():
    """Build (once per source hash) and load the kernel library.

    Raises RuntimeError when there is no CUDA device, no ``nvcc`` or the
    build fails; never returns a stand-in.
    """
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    lib, BUILD_LOG = build_and_load(_SRC, "transfer", _find_nvcc)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.transfer_x_launch.argtypes = [vp] * 4 + [ci] * 3 + [vp]
    lib.transfer_x_launch.restype = ci
    lib.transfer_yz_launch.argtypes = [vp] * 6 + [ci] * 5 + [vp]
    lib.transfer_yz_launch.restype = ci
    lib.transfer_yz_smem.argtypes = [ci, ci]
    lib.transfer_yz_smem.restype = ci
    _lib = lib
    return lib


def _check_x3(x3):
    if x3.device.type != "cuda":
        raise ValueError(
            f"the transfer kernels run on CUDA tensors, got {x3.device}")
    if x3.ndim != 3:
        raise ValueError(f"x3 must be lattice-shaped (3D), got {x3.ndim}D")
    _check("x3", x3, x3.shape, x3.device)


def transfer_x(x3, Mx):
    """Launch kernel #10 on CUDA tensors: ``t = Mx ._x x3``, a new
    ``(A, NY, NZ)`` lattice."""
    _check_x3(x3)
    NX, NY, NZ = x3.shape
    A = Mx.shape[0]
    _check("Mx", Mx, (A, NX), x3.device)
    if NY * NZ > 65535 * 256:
        raise ValueError(f"a ({NY}, {NZ}) plane exceeds the kernel's grid")
    rx = nonzero_ranges(Mx, 0)
    lib = load_kernels()
    t = torch.empty((A, NY, NZ), dtype=torch.float32, device=x3.device)
    with torch.cuda.device(x3.device):
        rc = lib.transfer_x_launch(_ptr(x3), _ptr(Mx), _ptr(rx), _ptr(t),
                                   NX, NY * NZ, A, stream_of(x3))
    if rc != 0:
        raise RuntimeError(f"transfer_x launch failed: CUDA error {rc}")
    LAUNCHES["transfer_x"] += 1
    return t


def transfer_yz(t, My, MzT):
    """Launch kernel #11 on CUDA tensors: ``out[a] = My t[a] MzT`` for
    every ``a``-slab of the ``(A, NY, NZ)`` lattice ``t``; a new ``(A, B,
    C)`` lattice."""
    _check_x3(t)
    A, NY, NZ = t.shape
    B, C = My.shape[0], MzT.shape[1]
    _check("My", My, (B, NY), t.device)
    _check("MzT", MzT, (NZ, C), t.device)
    lib = load_kernels()
    yc = lib.transfer_yz_smem(NY, NZ)
    if yc <= 0:
        raise ValueError(f"a z-extent of {NZ} does not fit the kernel's "
                         "shared memory")
    ry, rz = nonzero_ranges(My, 0), nonzero_ranges(MzT, 1)
    out = torch.empty((A, B, C), dtype=torch.float32, device=t.device)
    with torch.cuda.device(t.device):
        rc = lib.transfer_yz_launch(_ptr(t), _ptr(My), _ptr(ry), _ptr(MzT),
                                    _ptr(rz), _ptr(out), A, NY, NZ, B, C,
                                    stream_of(t))
    if rc != 0:
        raise RuntimeError(f"transfer_yz launch failed: CUDA error {rc}")
    LAUNCHES["transfer_yz"] += 1
    return out


def blocked_transfer(x3, Mx, My, MzT):
    """``y[a,b,c] = sum_{xyz} Mx[a,x] My[b,y] MzT[z,c] x3[x,y,z]``
    (lattice-shaped ``x3``). ``MzT`` arrives transposed (the
    z-contraction is a right-multiplication), as `transfer_mats` gives
    it. A CPU tensor runs `plain_transfer` (any float dtype); a CUDA
    tensor launches kernels #10 then #11 (float32) or raises."""
    if x3.device.type == "cpu":
        return plain_transfer(x3, Mx, My, MzT)
    return transfer_yz(transfer_x(x3, Mx), My, MzT)
