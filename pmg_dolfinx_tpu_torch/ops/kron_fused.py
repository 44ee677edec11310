"""Whole-lattice Kronecker-sum apply: a hand-written CUDA kernel and its
plain torch version.

Port of `pmg_dolfinx_tpu.ops.pallas_kron` (the module name drops
``pallas_`` as the port's other kernel modules do; the class keeps its JAX
name). On the bc-zeroed ``xb = where(bc, 0, x)``

    y = (Kx ._x xb) * myz + (Ky ._y xb) * mxz + (Kz ._z xb) * mxy

then ``where(bc, x, y)``, with the per-axis stiffness ``K`` (kappa folded
in) and the lumped-mass planes ``myz = my (x) mz``, ``mxz``, ``mxy`` of
`ops.kron.KronLaplacian`: the unsymmetrized form, so it differs from the
symmetrized `ops.kron.kron_laplacian_apply` and `ops.kron_blocked` in f32
rounding only.

- `kron_fused_apply(x3, bc3, Ks, planes)` — the entry point: a CPU tensor
  runs `plain_kron_fused`; a CUDA tensor launches `kron_fused` of
  `csrc/kron_fused.cu` or raises. There is no fallback. One launch: a
  block marches a tile of (y, z) outputs along x over a chunk of planes
  (`fused_plan`), each plane's tile loaded once with its y/z halo; the
  band (the widest distance of a nonzero from the diagonal, `fused_band`,
  from the ranges `band_ranges` finds once by
  `ops.transfer.nonzero_ranges`) is the march's template parameter, and
  a band above `MAX_BAND` takes the runtime-width form.
- `plain_kron_fused` — the TPU kernel's arithmetic as three einsums.
- `PallasKronLaplacian` — the operator bundle (apply, ``diag``,
  ``diag_inv``).

The TPU class pads the lattice to the (8, 128) tiling and keeps it whole in
VMEM, which limits its size (`pallas_kron.py:17-19`). The CUDA kernel
streams x from device memory plane by plane, so it takes no padding and
has no size limit. Not ported: ``interpret`` (its slot takes ``False``
only) and the padding.
The kernel is built with ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/`` (`ops.cuda_build`) and bound with `ctypes`. `LAUNCHES`
counts every launch.
"""

import ctypes
from pathlib import Path

import torch

from .cuda_build import build_and_load
from .cuda_build import check_operand as _check
from .cuda_build import find_nvcc as _find_nvcc
from .cuda_build import ptr as _ptr
from .cuda_build import stream_of
from .transfer import _sms, nonzero_ranges

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "kron_fused.cu"

# Kernel launches since the last reset: kernel name -> count. Raised only
# where the wrapper launches its kernel.
LAUNCHES = {"kron_fused": 0}

# The loaded library and the compiler's output of the build that made it.
_lib = None
BUILD_LOG = ""


def mass_planes(ms):
    """``(myz, mxz, mxy)``: the outer products of the per-axis lumped
    masses ``ms = (mx, my, mz)``, in their dtype (as the JAX class forms
    them from its float32 masses)."""
    mx, my, mz = ms
    return torch.outer(my, mz), torch.outer(mx, mz), torch.outer(mx, my)


def plain_kron_fused(x3, bc3, Ks, planes):
    """``where(bc, x, y)`` with ``y`` the three mass-scaled line
    contractions of the bc-zeroed ``x3``, as the TPU kernel sums them."""
    Kx, Ky, Kz = Ks
    myz, mxz, mxy = planes
    xb = torch.where(bc3, torch.zeros_like(x3), x3)
    t1 = torch.einsum("ax,xyz->ayz", Kx, xb) * myz[None]
    t2 = torch.einsum("by,xyz->xbz", Ky, xb) * mxz[:, None, :]
    t3 = torch.einsum("cz,xyz->xyc", Kz, xb) * mxy[:, :, None]
    return torch.where(bc3, x3, t1 + t2 + t3)


def load_kernels():
    """Build (once per source hash) and load the kernel library.

    Raises RuntimeError when there is no CUDA device, no ``nvcc`` or the
    build fails; never returns a stand-in.
    """
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    lib, BUILD_LOG = build_and_load(_SRC, "kron_fused", _find_nvcc)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.kron_fused_launch.argtypes = [vp] * 10 + [ci] * 5 + [vp]
    lib.kron_fused_launch.restype = ci
    _lib = lib
    return lib


def band_ranges(Ks):
    """The nonzero ranges of the rows of ``Kx``, ``Ky``, ``Kz`` in the
    kernel's layout, one int32 vector ``[lo_x, hi_x, lo_y, hi_y, lo_z,
    hi_z]`` (cached on the matrices by `nonzero_ranges`)."""
    return torch.cat([nonzero_ranges(K, 0).reshape(-1) for K in Ks])


# The march's templated bands (above: the runtime-width form), its tile
# of TILE_Z x TILE_Y outputs, the longest chunk of planes a block
# outputs, and the chunk rule of kron_t1_m's march: the longest chunk
# when the card still gets LONG_BLOCKS_PER_SM blocks per SM, else the
# longest of 32, 16, ..., 2 that gives every SM a block.
MAX_BAND = 8
TILE_Z, TILE_Y = 64, 8
LONG_CHUNK, SHORT_CHUNK, MIN_CHUNK = 64, 32, 2
LONG_BLOCKS_PER_SM = 3


def fused_band(ranges, shape):
    """The widest distance of a nonzero from the diagonal over the rows of
    ``Kx``, ``Ky``, ``Kz`` (0 for diagonal or zero matrices), from their
    `band_ranges` layout; one host read, cached on ``ranges`` with its
    version."""
    hit = getattr(ranges, "_pmg_band", None)
    if hit is not None and hit[0] == ranges._version:
        return hit[1]
    band, off = 0, 0
    for n in shape:
        lo = ranges[off:off + n].long()
        hi = ranges[off + n:off + 2 * n].long()
        off += 2 * n
        i = torch.arange(n, device=ranges.device)
        full = hi > lo
        if bool(full.any()):
            d = torch.maximum(i - lo, hi - 1 - i)[full]
            band = max(band, int(d.max()))
    ranges._pmg_band = (ranges._version, band)
    return band


def fused_plan(shape, band, sms):
    """The launch plan ``(band, chunk)`` of `kron_fused` on an ``(NX, NY,
    NZ)`` lattice whose matrices reach ``band`` off the diagonal, on a
    card of ``sms`` SMs: ``band`` -1 (the runtime-width form) above
    `MAX_BAND`; ``chunk`` the planes a block outputs along x, by the rule
    above, for the layer of ``ceil(NZ / TILE_Z) * ceil(NY / TILE_Y)``
    tiles."""
    NX, NY, NZ = shape
    if band > MAX_BAND:
        return -1, 0
    layer = -(-NZ // TILE_Z) * -(-NY // TILE_Y)
    blocks = lambda c: layer * -(-NX // c)
    if blocks(LONG_CHUNK) >= LONG_BLOCKS_PER_SM * sms:
        return band, LONG_CHUNK
    c = SHORT_CHUNK
    while c > MIN_CHUNK and blocks(c) < sms:
        c //= 2
    return band, c


def kron_fused(x3, bc3, Ks, planes, ranges=None):
    """Launch the kernel on CUDA tensors: ``where(bc, x, y)`` as a new
    ``(NX, NY, NZ)`` lattice. ``ranges`` from `band_ranges` (formed here
    when not given); the plan (`fused_plan`) from their band, read to the
    host once per ranges tensor."""
    if x3.device.type != "cuda":
        raise ValueError(
            f"the kron_fused kernel runs on CUDA tensors, got {x3.device}")
    if x3.ndim != 3:
        raise ValueError(f"x must be lattice-shaped (3D), got {x3.ndim}D")
    NX, NY, NZ = x3.shape
    dev = x3.device
    _check("x", x3, x3.shape, dev)
    _check("bc", bc3, x3.shape, dev, torch.bool)
    for name, K, n in zip(("Kx", "Ky", "Kz"), Ks, (NX, NY, NZ)):
        _check(name, K, (n, n), dev)
    for name, m, s in zip(("myz", "mxz", "mxy"), planes,
                          ((NY, NZ), (NX, NZ), (NX, NY))):
        _check(name, m, s, dev)
    if ranges is None:
        ranges = band_ranges(Ks)
    _check("ranges", ranges, (2 * (NX + NY + NZ),), dev, torch.int32)
    if NX * NY * NZ >= 2**31:
        raise ValueError(f"a {tuple(x3.shape)} lattice exceeds the kernel's "
                         "32-bit offsets")
    band, chunk = fused_plan(x3.shape, fused_band(ranges, x3.shape),
                             _sms(dev))
    lib = load_kernels()
    out = torch.empty_like(x3)
    with torch.cuda.device(dev):
        rc = lib.kron_fused_launch(
            _ptr(x3), _ptr(bc3), *(_ptr(K) for K in Ks), _ptr(ranges),
            *(_ptr(m) for m in planes), _ptr(out), NX, NY, NZ, band, chunk,
            stream_of(x3))
    if rc != 0:
        raise RuntimeError(f"kron_fused launch failed: CUDA error {rc}")
    LAUNCHES["kron_fused"] += 1
    return out


def kron_fused_apply(x3, bc3, Ks, planes, ranges=None):
    """The whole-lattice apply on a lattice-shaped ``x3`` with the bool
    marker ``bc3``: `plain_kron_fused` on a CPU tensor (any float dtype),
    the CUDA kernel (float32) on a CUDA tensor."""
    if x3.device.type == "cpu":
        return plain_kron_fused(x3, bc3, Ks, planes)
    return kron_fused(x3, bc3, Ks, planes, ranges)


class PallasKronLaplacian:
    """The whole-lattice fused Kronecker-sum apply as an operator
    (float32) on ``device``: ``op(x)`` returns the flat ``A x`` (as the JAX
    class does), with ``diag`` and ``diag_inv`` of
    `ops.kron.KronLaplacian`. ``kappa`` is a scalar; ``interpret`` keeps
    the JAX package's fourth parameter (``False`` only)."""

    def __init__(self, mesh, P, kappa=2.0, interpret=False, *, device):
        from .kron import KronLaplacian
        from .kron_blocked import _tpu_knob

        _tpu_knob("interpret", interpret, False)

        base = KronLaplacian(mesh, P, kappa=kappa, dtype=torch.float32,
                             device=device)
        self.P = int(P)
        self.mesh = mesh
        self.ndofs = base.ndofs
        self.shape = base.shape
        self.device = torch.device(device)
        self.diag = base.diag
        self.diag_inv = base.diag_inv
        self.Ks = base.Ks
        self.planes = mass_planes(base.ms)
        self.bc3 = base.bc_marker.reshape(self.shape)
        self.ranges = band_ranges(self.Ks)
        self.band = fused_band(self.ranges, self.shape)   # the host read

    def __call__(self, x):
        x3 = torch.as_tensor(x, dtype=torch.float32,
                             device=self.device).reshape(self.shape)
        return kron_fused_apply(x3, self.bc3, self.Ks, self.planes,
                                self.ranges).reshape(-1)
