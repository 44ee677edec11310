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
  reaches device memory, marching each (y, z) column along x through a
  segment of output rows (the plan `x_plan`), and `transfer_yz` (#11,
  ``_kernel_tyz``) forms ``My t_a MzT`` for each ``a``-slab, marching
  along y with the rows' window in registers (no block barrier in the
  march), on the launch plan `yz_plan` picks once per shape.
- The kernels sum each row only over its nonzero range ``[lo, hi)``:
  `nonzero_ranges` finds it on the device, from the matrix itself, and
  caches it on the matrix with the widest range (`nonzero_width`, read
  to the host once) and the lines' order by ``hi`` (recomputed only after
  an in-place write), so the result is the dense product's for any
  matrix the caller passes.
- `plain_transfer` — the three einsums in the JAX package's x, y, z order
  (its emulation path); `plain_transfer_x` / `plain_transfer_yz` are the
  two kernels' halves of it.

The kernels are built with ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/`` (`ops.cuda_build`) and bound with `ctypes`. `LAUNCHES`
counts every kernel launch.

Not ported: the TPU kernels' slab sizes ``by``/``bx`` (the CUDA kernels
fix their own tiles) and ``interpret``: `blocked_transfer` keeps them as
keywords that take JAX's defaults only.
"""

import ctypes
from pathlib import Path

import torch

from .cuda_build import build_and_load
from .cuda_build import check_operand as _check
from .cuda_build import find_nvcc as _find_nvcc
from .cuda_build import on_device as _on_device
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


def _nz_lines(M, axis):
    """``(ranges, width, order)`` of the rows (``axis=0``) or columns
    (``axis=1``) of ``M``, cached on ``M`` with its version counter."""
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
    width = int((hi - lo).max()) if hi.numel() else 0   # the one host read
    order = torch.argsort(hi, stable=True).to(torch.int32).contiguous()
    lines = (ranges, width, order)
    setattr(M, key, (M._version, lines))
    return lines


def nonzero_ranges(M, axis=0):
    """``[lo, hi)`` of the nonzeros of each row (``axis=0``) or column
    (``axis=1``) of the 2D ``M``, as a ``(2, n)`` int32 tensor on ``M``'s
    device (``lo = hi = 0`` for an all-zero line). Computed once per
    tensor, with the widest range (`nonzero_width`, the one host read) and
    the lines' stable order by ``hi``: all three are cached on ``M`` with
    its version counter, so an in-place write recomputes them."""
    return _nz_lines(M, axis)[0]


def nonzero_width(M, axis=0):
    """The widest ``hi - lo`` of `nonzero_ranges` ``(M, axis)``, an int
    cached beside the ranges (no host read after the first call)."""
    return _nz_lines(M, axis)[1]


# The ring widths transfer_yz is compiled for (0: the runtime-width
# variant, for any wider range), and its rows per block.
YZ_WIDTHS = (4, 8, 12, 16)
YZ_ROWS = (32, 16, 8, 4)
_MAX_SMEM = 227 * 1024     # dynamic shared memory a block may use
_PLANS = {}
_SMS = {}


def yz_smem(W, RB, NZ, C):
    """Shared-memory bytes of a `transfer_yz` block (``csrc/transfer.cu``
    ``yz_smem``): u rows, the MzT band, the rows' My coefficients, their
    b / lo / hi and the columns' lo / length."""
    return 4 * (RB * NZ + W * C + RB * W) + 4 * (3 * RB + 2 * C)


def yz_plan(A, NZ, B, C, width, sms):
    """The launch plan ``(W, RB)`` of `transfer_yz` for ``t`` of ``(A, .,
    NZ)``, ``out`` of ``(A, B, C)``, widest nonzero range ``width`` on a
    card of ``sms`` SMs: ``W`` the narrowest ring width of `YZ_WIDTHS`
    that holds ``width`` (0 when none does), ``RB`` the most rows per
    block (`YZ_ROWS`) whose shared memory fits and that still gives the
    card three blocks for every two SMs (a block's rows share its
    y-window; more rows, fewer halo rows read twice), else the fewest that
    fit. Raises ValueError when no block's shared memory fits."""
    key = (A, NZ, B, C, width, sms)
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    W = next((w for w in YZ_WIDTHS if w >= width), 0)
    fits = [rb for rb in YZ_ROWS if yz_smem(W, rb, NZ, C) <= _MAX_SMEM]
    if not fits:
        raise ValueError(f"a ({NZ} -> {C}) z-contraction does not fit the "
                         "kernel's shared memory")
    RB = next((rb for rb in fits if 2 * A * -(-B // rb) >= 3 * sms),
              fits[-1])
    plan = _PLANS[key] = (W, RB)
    return plan


def _yz_rows(My, W):
    """The row operands of ``My`` for a march over its rows (`transfer_yz`
    on ``My``, `transfer_x` on ``Mx``), laid out once per ring width ``W``
    and cached on ``My`` with its version: ``(rows, coef)``, ``rows`` (3,
    B) int32 the rows in the stable order of their ranges' ends
    (`nonzero_ranges`) with their ``lo`` and ``hi``, ``coef`` (B, W)
    float32 ``My[b, hi - W + d]`` for ``hi - W + d >= lo``, else 0 (None
    for ``W = 0``). Device ops only: no host read."""
    cache = getattr(My, "_pmg_yz_rows", None)
    if cache is None or cache[0] != My._version:
        cache = My._pmg_yz_rows = (My._version, {})
    hit = cache[1].get(W)
    if hit is not None:
        return hit
    ranges, _, order = _nz_lines(My, 0)
    o = order.long()
    lo, hi = ranges[0].long()[o], ranges[1].long()[o]
    rows = torch.stack([o, lo, hi]).to(torch.int32).contiguous()
    coef = None
    if W:
        y = hi[:, None] - W + torch.arange(W, device=My.device)
        coef = torch.where(y >= lo[:, None], My[o[:, None], y.clamp(min=0)],
                           0.0).to(torch.float32).contiguous()
    cache[1][W] = rows, coef
    return rows, coef


def _yz_band(MzT, W):
    """`transfer_yz`'s column band of ``MzT``, (W, C) float32 ``MzT[lo +
    d, c]`` for ``d < hi - lo``, else 0 (None for ``W = 0``), laid out once
    per ring width and cached on ``MzT`` with its version."""
    if not W:
        return None
    hit = getattr(MzT, "_pmg_yz_band", None)
    if hit is not None and hit[0] == (MzT._version, W):
        return hit[1]
    lo, hi = nonzero_ranges(MzT, 1).long()
    z = lo[None, :] + torch.arange(W, device=MzT.device)[:, None]
    c = torch.arange(MzT.shape[1], device=MzT.device)[None, :]
    band = torch.where(z < hi[None, :],
                       MzT[z.clamp(max=MzT.shape[0] - 1), c],
                       0.0).to(torch.float32).contiguous()
    MzT._pmg_yz_band = ((MzT._version, W), band)
    return band


def _yz_launch(t, My, MzT):
    """The launch record of `transfer_yz` for ``t`` on ``(My, MzT)``: ``(W,
    RB)`` from `yz_plan` and the device pointers of the laid-out operands
    (rows, coefficients, column ranges, band). Cached on ``My`` (the
    V-cycle keeps one ``MzT`` per ``My``) with the operands it points to,
    and rebuilt when ``MzT``, either version, ``A`` or the device changes,
    so a launch reads one attribute."""
    key = (My._version, MzT._version, t.shape[0], t.device.index)
    hit = getattr(My, "_pmg_yz_launch", None)
    if hit is not None and hit[0] is MzT and hit[1] == key:
        return hit[2]
    A, NZ, B, C = t.shape[0], t.shape[2], My.shape[0], MzT.shape[1]
    W, RB = yz_plan(A, NZ, B, C, max(nonzero_width(My, 0),
                                     nonzero_width(MzT, 1)), _sms(t.device))
    rows, coef = _yz_rows(My, W)
    operands = (rows, coef, nonzero_ranges(MzT, 1), _yz_band(MzT, W))
    record = (W, RB) + tuple(None if x is None else x.data_ptr()
                             for x in operands)
    My._pmg_yz_launch = (MzT, key, record, operands)
    return record


# transfer_x: output rows per block (a segment marches the union of its
# rows' ranges) and the rows of the segments that must fill the card for
# the march to beat the direct form.
X_ROWS = (64, 32, 16, 8, 4, 2, 1)
X_MIN_ROWS = 8
_XPLANS = {}


def x_plan(A, NYZ, width, sms):
    """The launch plan ``(W, S, C)`` of `transfer_x` for ``A`` output rows
    over a plane of ``NYZ`` columns, widest nonzero range ``width``, on a
    card of ``sms`` SMs: ``W`` the narrowest ring width of `YZ_WIDTHS`
    that holds ``width`` (0 when none does), ``C`` the columns a thread
    marches (4, or 2 for rings of 12 and more and the runtime width), and
    ``S`` the most rows per block of `X_ROWS` that still gives every SM a
    block of 256 threads (a segment re-reads the rows of x3 its
    neighbour's ranges share; more rows, fewer such rows). When segments
    of `X_MIN_ROWS` rows cannot give every SM two blocks, the march cannot
    hide its latency and ``S`` is 0: the direct form, a thread per output
    (on the H100 it was faster at 127^3 -> 43^3 and 43^3 -> 127^3)."""
    key = (A, NYZ, width, sms)
    plan = _XPLANS.get(key)
    if plan is not None:
        return plan
    W = next((w for w in YZ_WIDTHS if w >= width), 0)
    C = 2 if W == 0 or W >= 12 else 4
    cols = -(-NYZ // (256 * C))
    if cols * -(-A // X_MIN_ROWS) < 2 * sms:
        S = 0
    else:
        S = next(s for s in X_ROWS if cols * -(-A // s) >= sms)
    plan = _XPLANS[key] = (W, S, C)
    return plan


def _x_launch(x3, Mx):
    """The launch record of `transfer_x` for ``x3`` on ``Mx``: ``(W, S,
    C)`` from `x_plan` and the device pointers of the laid-out rows and
    coefficients (`_yz_rows`), cached on ``Mx`` with them and rebuilt
    when its version, the plane or the device changes."""
    NYZ = x3.shape[1] * x3.shape[2]
    key = (Mx._version, NYZ, x3.device.index)
    hit = getattr(Mx, "_pmg_x_launch", None)
    if hit is not None and hit[0] == key:
        return hit[1]
    plan = x_plan(Mx.shape[0], NYZ, nonzero_width(Mx, 0), _sms(x3.device))
    operands = _yz_rows(Mx, plan[0])
    record = plan + tuple(None if x is None else x.data_ptr()
                          for x in operands)
    Mx._pmg_x_launch = (key, record, operands)
    return record


def yz_blocks_per_sm(W, RB, NZ, C):
    """Blocks of `transfer_yz` one SM of the current card holds on the plan
    ``(W, RB)`` at ``NZ -> C`` (the CUDA occupancy API)."""
    return load_kernels().transfer_yz_blocks_per_sm(W, RB, NZ, C)


def _sms(device):
    """The SM count of a CUDA device, read once per device."""
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


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
    lib.transfer_x_launch.argtypes = [vp] * 5 + [ci] * 6 + [vp]
    lib.transfer_x_launch.restype = ci
    lib.transfer_yz_launch.argtypes = [vp] * 8 + [ci] * 7 + [vp]
    lib.transfer_yz_launch.restype = ci
    lib.transfer_yz_blocks_per_sm.argtypes = [ci] * 4
    lib.transfer_yz_blocks_per_sm.restype = ci
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
    ``(A, NY, NZ)`` lattice. The plan (`x_plan`) and the row operands are
    cached on ``Mx``, so a launch makes no host read."""
    _check_x3(x3)
    NX, NY, NZ = x3.shape
    A = Mx.shape[0]
    _check("Mx", Mx, (A, NX), x3.device)
    if NX * NY * NZ >= 2**31:
        raise ValueError(f"a {tuple(x3.shape)} lattice exceeds the kernel's "
                         "32-bit offsets")
    W, S, C, rows, coef = _x_launch(x3, Mx)
    lib = load_kernels()
    t = torch.empty((A, NY, NZ), dtype=torch.float32, device=x3.device)
    with _on_device(x3):
        rc = lib.transfer_x_launch(x3.data_ptr(), Mx.data_ptr(), rows, coef,
                                   t.data_ptr(), NX, NY * NZ, A, W, S, C,
                                   stream_of(x3))
    if rc != 0:
        raise RuntimeError(f"transfer_x launch failed: CUDA error {rc}")
    LAUNCHES["transfer_x"] += 1
    return t


def transfer_yz(t, My, MzT):
    """Launch kernel #11 on CUDA tensors: ``out[a] = My t[a] MzT`` for
    every ``a``-slab of the ``(A, NY, NZ)`` lattice ``t``; a new ``(A, B,
    C)`` lattice. The plan (`yz_plan`) comes from the ranges' cached
    widths, so a launch makes no host read; every array is checked on
    every launch."""
    _check_x3(t)
    A, NY, NZ = t.shape
    B, C = My.shape[0], MzT.shape[1]
    _check("My", My, (B, NY), t.device)
    _check("MzT", MzT, (NZ, C), t.device)
    W, RB, rows, coef, rz, band = _yz_launch(t, My, MzT)
    lib = load_kernels()
    out = torch.empty((A, B, C), dtype=torch.float32, device=t.device)
    with _on_device(t):
        rc = lib.transfer_yz_launch(
            t.data_ptr(), My.data_ptr(), rows, coef, MzT.data_ptr(), rz,
            band, out.data_ptr(), A, NY, NZ, B, C, W, RB, stream_of(t))
    if rc != 0:
        raise RuntimeError(f"transfer_yz launch failed: CUDA error {rc}")
    LAUNCHES["transfer_yz"] += 1
    return out


def blocked_transfer(x3, Mx, My, MzT, *, by=8, bx=8, interpret=None):
    """``y[a,b,c] = sum_{xyz} Mx[a,x] My[b,y] MzT[z,c] x3[x,y,z]``
    (lattice-shaped ``x3``). ``MzT`` arrives transposed (the
    z-contraction is a right-multiplication), as `transfer_mats` gives
    it. A CPU tensor runs `plain_transfer` (any float dtype); a CUDA
    tensor launches kernels #10 then #11 (float32) or raises. The JAX
    package's slab sizes ``by``/``bx`` and ``interpret`` take its
    defaults only."""
    from .kron_blocked import _tpu_knobs

    _tpu_knobs(by, bx, interpret)
    if x3.device.type == "cpu":
        return plain_transfer(x3, Mx, My, MzT)
    return transfer_yz(transfer_x(x3, Mx), My, MzT)
