"""General-hex (curved) apply: hand-written CUDA kernels and their plain
torch versions.

Port of `pmg_dolfinx_tpu.ops.pallas_lattice_blocked`:

- host setup, as in the JAX package: `lattice_blocked_mats`,
  `geometry_to_gfirst`, `lattice_geom_coefficients`, `lattice_geom_data`
  and `geom_to_G` (numpy float64, or torch for the plain version), and
  for the z-grouped variant `select_zgroup`, `zgroup_matrices` and
  `geometry_to_zgrouped`;
- `blocked_lattice_apply` (variants 'yexp', 'v1', 'ym'),
  `blocked_lattice_apply_zgrp` ('zgrp') and `blocked_lattice_apply_geom`
  ('geom') — the entry points. On a CPU tensor they run the plain torch
  version; on a CUDA tensor they launch the kernels of
  `csrc/lattice_blocked.cu` or raise. There is no fallback from CUDA to
  the plain version. The three TPU variants lay the same ``y = A x`` out
  differently over VMEM and the MXU, so all three launch one kernel here
  (K-A, `lattice_apply`); 'zgrp' launches K-A on the z-grouped geometry
  ``Gz`` (`lattice_apply_zgrp`: the TPU kernel's group matrices are an
  MXU device, K-A contracts z cell by cell and only addresses ``Gz``
  differently); 'geom' launches K-B (`lattice_apply_geom`), which
  rebuilds G in the kernel from 37 floats per cell;
- `plain_lattice_apply`, `plain_lattice_apply_zgrp`,
  `plain_lattice_apply_geom` — the JAX package's emulation paths
  (`lattice_laplacian_apply` on ``moveaxis(Gt, 0, -1)``, on the un-grouped
  ``Gz``, or on `geom_to_G` of the coefficients), used by the CPU tests
  and compared with the kernels on the card by `chip_smoke.py`;
- `PallasLatticeBlocked` — the operator bundle (apply + exact diagonal).

Each apply on the card is one streaming pass: a block marches along x
through a box of cells (`lattice_plan`) and folds the overlap-add of its
own cells on chip; the dofs on faces between boxes go to a face scratch
(`face_scratch_bytes`, taken from the caching allocator on each call,
never a cell-expanded lattice) that a second, small launch sums in a
fixed order (`csrc/lattice_blocked.cu`). The kernels are built with
``nvcc`` for ``sm_90a`` at first use into ``build/kernels/``
(`ops.cuda_build`) and bound through a plain C interface with `ctypes`.
`LAUNCHES` counts one per apply.

Not ported: ``precision="high"`` (bf16x3), and the TPU tile knobs
``bcells`` and ``interpret`` (they keep their positions in
`PallasLatticeBlocked`; anything but JAX's default raises).
"""

import ctypes
from pathlib import Path

import numpy as np
import torch

from .cuda_build import build_and_load
from .cuda_build import check_operand as _check
from .cuda_build import find_nvcc as _find_nvcc
from .cuda_build import on_device as _on_device
from .cuda_build import stream_of
from .kron_blocked import _check_precision, _tpu_knob
from .lattice import axis_matrices, lattice_laplacian_apply

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "lattice_blocked.cu"

# Kernel launches since the last reset: kernel name -> count. Raised only
# where a wrapper launches its kernel.
LAUNCHES = {"lattice_apply": 0, "lattice_apply_zgrp": 0,
            "lattice_apply_geom": 0}

# Degrees the kernels are compiled for (csrc/lattice_blocked.cu, N = P+1).
DEGREES = (1, 2, 3, 4, 5, 6)

# The loaded library and the compiler's output of the build that made it.
_lib = None
BUILD_LOG = ""

_MATS_PLAIN = ("Ex", "Dx", "Ey", "Dy", "Ez", "Dz")


# --- host setup ---------------------------------------------------------------

def lattice_blocked_mats(nc, P, dtype=torch.float32, *, device):
    """The per-axis matrices of the lattice form (``Ex..DzT``) and the 1D
    GLL derivative ``D1``, as in the JAX package. The kernels read ``D1``
    only; the plain version reads ``Ex, Dx, Ey, Dy, Ez, Dz``."""
    from ..fem.gll import derivative_matrix

    ncx, ncy, ncz = nc
    Ex, Dx = axis_matrices(ncx, P)
    Ey, Dy = axis_matrices(ncy, P)
    Ez, Dz = axis_matrices(ncz, P)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return dict(
        Ex=f(Ex), Dx=f(Dx),
        Ey=f(Ey), EyT=f(Ey.T.copy()), Dy=f(Dy), DyT=f(Dy.T.copy()),
        Ez=f(Ez), EzT=f(Ez.T.copy()), Dz=f(Dz), DzT=f(Dz.T.copy()),
        D1=f(derivative_matrix(P)),
    )


def _pad128(v):
    return -(-int(v) // 128) * 128


def select_zgroup(ncz, P, max_groups=8, margin=0.8):
    """The JAX package's z-group size ``zb`` for the 'zgrp' variant, or
    None: the divisor of ``ncz`` (2 to ``max_groups`` groups) whose padded
    TPU matrix-unit cost ``ngz * pad128(zb*P+1) * pad128(zb*(P+1))`` beats
    the dense ``pad128(NZ) * pad128(Qz)`` by at least ``1 - margin``. A
    model of the TPU, kept so that ``zb`` is chosen as in the reference."""
    n = P + 1
    dense = _pad128(ncz * P + 1) * _pad128(ncz * n)
    best, best_cost = None, dense * margin
    for zb in range(1, ncz):
        if ncz % zb:
            continue
        ngz = ncz // zb
        if ngz < 2 or ngz > max_groups:
            continue
        cost = ngz * _pad128(zb * P + 1) * _pad128(zb * n)
        if cost < best_cost:
            best, best_cost = zb, cost
    return best


def zgroup_matrices(zb, P, dtype=torch.float32, *, device):
    """The z-block expansion/derivative matrices every group shares
    (`axis_matrices` of a ``zb``-cell axis, ``(zb*(P+1), zb*P+1)``), as in
    the JAX package. The CUDA kernel does not read them."""
    E, Dg = axis_matrices(zb, P)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return dict(EzTb=f(E.T.copy()), Ezb=f(E), DzTb=f(Dg.T.copy()),
                Dzb=f(Dg))


def geometry_to_zgrouped(Gq, zb, P):
    """Reorder quadrature-lattice geometry ``(Qx, Qy, Qz, 6)`` to the
    z-grouped layout ``(Qx, 6*ngz, Qy, zb*(P+1))`` (numpy; entry-major on
    dim 1), as the JAX package does once at setup."""
    Gq = np.asarray(Gq)
    Qx, Qy, Qz, _ = Gq.shape
    zbn = zb * (P + 1)
    ngz = Qz // zbn
    G = Gq.reshape(Qx, Qy, ngz, zbn, 6)
    G = np.transpose(G, (0, 4, 2, 1, 3))    # (Qx, 6, ngz, Qy, zbn)
    return np.ascontiguousarray(G.reshape(Qx, 6 * ngz, Qy, zbn))


def zgrouped_to_qlattice(Gz, nc, P, zb):
    """Inverse of `geometry_to_zgrouped` for a tensor: ``(Qx, Qy, Qz, 6)``
    (a view where torch can make one)."""
    ncx, ncy, ncz = nc
    n = P + 1
    ngz = ncz // zb
    return torch.permute(Gz.reshape(ncx * n, 6, ngz, ncy * n, zb * n),
                         (0, 3, 2, 4, 1)).reshape(ncx * n, ncy * n,
                                                  ncz * n, 6)


def geometry_to_gfirst(Gq):
    """Reorder the quadrature-lattice geometry ``(Qx, Qy, Qz, 6)`` to
    ``(6, Qx, Qy, Qz)`` (numpy): the layout the kernels read, runs of
    ``Qz`` floats along z."""
    return np.ascontiguousarray(np.moveaxis(np.asarray(Gq), -1, 0))


def _bilinear_coeffs(f):
    """Coefficients (A, B, C, D) of ``A + B s + C t + D s t`` from corner
    values ``f[..., s, t]`` (s, t in {0, 1})."""
    A = f[..., 0, 0]
    B = f[..., 1, 0] - A
    C = f[..., 0, 1] - A
    D = f[..., 1, 1] - f[..., 1, 0] - f[..., 0, 1] + A
    return A, B, C, D


def lattice_geom_coefficients(mesh, P, kappa_cells):
    """Per-cell Jacobian coefficient grids ``(37, ncx, ncy, ncz)`` f64.

    Row ``(i*3 + j)*4 + term`` holds bilinear term ``term`` (1, s, t, st)
    of ``J[i][j] = d x_i / d xi_j`` over its two free reference
    coordinates (the trilinear map's derivative along j is constant in
    coordinate j); row 36 is the DG-0 coefficient."""
    ncx, ncy, ncz = mesh.nc
    coords = np.asarray(mesh.geometry_x)[np.asarray(mesh.geometry_dofmap)]
    # Corner index (a*2 + b)*2 + c (tabulate_geometry_dphi convention).
    X = coords.reshape(ncx, ncy, ncz, 2, 2, 2, 3)
    co = np.empty((37, ncx, ncy, ncz), np.float64)
    cols = (
        X[:, :, :, 1, :, :, :] - X[:, :, :, 0, :, :, :],  # d/dxi: (b, c)
        X[:, :, :, :, 1, :, :] - X[:, :, :, :, 0, :, :],  # d/deta: (a, c)
        X[:, :, :, :, :, 1, :] - X[:, :, :, :, :, 0, :],  # d/dzeta: (a, b)
    )
    for j, fj in enumerate(cols):
        # (..., s, t, 3) -> (..., 3, s, t): free corner pair last.
        terms = _bilinear_coeffs(np.moveaxis(fj, -1, -3))
        for i in range(3):
            for t in range(4):
                co[(i * 3 + j) * 4 + t] = terms[t][..., i]
    co[36] = np.asarray(kappa_cells, np.float64).reshape(ncx, ncy, ncz)
    return co


def _cell_expansion_1d(nc, vals):
    """(nc*n, nc) cell->point expansion ``S[c*n + j, c] = vals[j]``."""
    n = vals.shape[0]
    S = np.zeros((nc * n, nc))
    rows = np.arange(nc * n)
    S[rows, rows // n] = vals[rows % n]
    return S


def lattice_geom_data(nc, P, dtype=torch.float32, *, device):
    """The JAX package's geom-kernel tables: the cell->point expansion
    matrices (``Sy, SyE, SyW, SzT, SzET, SzWT``, used by its TPU kernel)
    and the GLL point and weight tuples ``xi``, ``wx``, which K-B reads."""
    from ..fem.gll import gauss_lobatto

    ncx, ncy, ncz = nc
    n = P + 1
    q1, w1 = gauss_lobatto(n)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return dict(
        Sy=f(_cell_expansion_1d(ncy, np.ones(n))),
        SyE=f(_cell_expansion_1d(ncy, q1)),
        SyW=f(_cell_expansion_1d(ncy, w1)),
        SzT=f(_cell_expansion_1d(ncz, np.ones(n)).T.copy()),
        SzET=f(_cell_expansion_1d(ncz, q1).T.copy()),
        SzWT=f(_cell_expansion_1d(ncz, w1).T.copy()),
    ), tuple(float(v) for v in q1), tuple(float(v) for v in w1)


def geom_to_G(co, nc, P, xp=np):
    """Quadrature-lattice geometry ``(Qx, Qy, Qz, 6)`` rebuilt from the
    coefficient grids: numpy float64 for a numpy ``co``, torch in
    ``co``'s dtype and device for a tensor (the plain version of K-B).
    ``xp`` keeps the JAX package's fourth parameter, its array module:
    numpy only here (the array type of ``co`` picks the module), anything
    else raises ValueError."""
    if xp is not np:
        raise ValueError(
            f"xp={xp!r}: geom_to_G follows the type of co (numpy or torch); "
            "pass xp=numpy, the JAX package's default")
    from ..fem.geometry import _adjugate_3x3
    from ..fem.gll import gauss_lobatto

    xp = torch if isinstance(co, torch.Tensor) else np
    ncx, ncy, ncz = nc
    n = P + 1
    q1, w1 = gauss_lobatto(n)
    if xp is np:
        co = np.asarray(co, np.float64)
        cast = lambda a: a
    else:
        cast = lambda a: torch.tensor(a, dtype=co.dtype, device=co.device)
    # Block-form coordinate factors over (ncx, n, ncy, n, ncz, n).
    xi = cast(q1.reshape(1, n, 1, 1, 1, 1))
    eta = cast(q1.reshape(1, 1, 1, n, 1, 1))
    zeta = cast(q1.reshape(1, 1, 1, 1, 1, n))
    free = {0: (eta, zeta), 1: (xi, zeta), 2: (xi, eta)}
    cell = lambda t: co[t][:, None, :, None, :, None]
    Jcols = []
    for i in range(3):
        row = []
        for j in range(3):
            s, t = free[j]
            base = (i * 3 + j) * 4
            v = (cell(base) + cell(base + 1) * s
                 + cell(base + 2) * t + cell(base + 3) * s * t)
            row.append(xp.broadcast_to(v, (ncx, n, ncy, n, ncz, n)))
        Jcols.append(xp.stack(row, axis=-1))
    Jq = xp.stack(Jcols, axis=-2)      # (..., i, j)
    K = _adjugate_3x3(Jq, xp=xp)
    det = (Jq[..., 0, 0] * K[..., 0, 0] + Jq[..., 1, 0] * K[..., 0, 1]
           + Jq[..., 2, 0] * K[..., 0, 2])
    KKt = xp.einsum("...am,...bm->...ab", K, K)
    w = cast(np.einsum("i,j,k->ijk", w1, w1, w1)[None, :, None, :, None, :])
    scale = w * cell(36) / det
    G = xp.stack(
        [KKt[..., 0, 0], KKt[..., 1, 0], KKt[..., 2, 0],
         KKt[..., 1, 1], KKt[..., 2, 1], KKt[..., 2, 2]],
        axis=-1,
    ) * scale[..., None]
    # Block order (ncx, n, ncy, n, ncz, n, 6) IS the lattice layout.
    return G.reshape(ncx * n, ncy * n, ncz * n, 6)


# --- plain torch versions -----------------------------------------------------

def plain_lattice_apply(x, mats, Gt, bc_marker, apply_bc=True):
    """K-A's function: `lattice_laplacian_apply` on ``moveaxis(Gt, 0, -1)``
    (the JAX emulation path), any float dtype, shape-preserving."""
    return lattice_laplacian_apply(
        x, {k: mats[k] for k in _MATS_PLAIN}, torch.movedim(Gt, 0, -1),
        bc_marker, apply_bc=apply_bc)


def plain_lattice_apply_zgrp(x, mats, Gz, bc_marker, nc, P, zb,
                             apply_bc=True):
    """The function of K-A on ``Gz``: `lattice_laplacian_apply` on the
    un-grouped geometry (the JAX emulation path)."""
    return lattice_laplacian_apply(
        x, {k: mats[k] for k in _MATS_PLAIN},
        zgrouped_to_qlattice(Gz, nc, P, zb), bc_marker, apply_bc=apply_bc)


def plain_lattice_apply_geom(x, mats, co, bc_marker, nc, P, apply_bc=True):
    """K-B's function: `geom_to_G` of the coefficients, then
    `lattice_laplacian_apply`."""
    return lattice_laplacian_apply(
        x, {k: mats[k] for k in _MATS_PLAIN}, geom_to_G(co, nc, P),
        bc_marker, apply_bc=apply_bc)


# --- CUDA kernels -------------------------------------------------------------

# Cells per box along (y, z) by degree, and along x, the march: the
# boxes of ``csrc/lattice_blocked.cu``'s ``lattice_march`` that ran fastest
# on an H100 at the curved V-cycle's levels (tools/lattice_bench_torch.py
# --sweep); at p=6 a block of 147 threads keeps its sums in registers.
BOX = {1: (4, 14), 2: (3, 8), 3: (2, 7), 4: (2, 4), 5: (1, 6), 6: (1, 3)}
MARCH = 6


def max_threads(P, kernel="lattice_apply"):
    """The threads a block of ``kernel`` may have at degree ``P``: 384 for
    K-A at P >= 4, else 256 (``max_threads`` of the CUDA source, whose
    launch refuses a larger box). `lattice_plan` fits 'zgrp' boxes to it."""
    return 384 if kernel != "lattice_apply_geom" and P >= 4 else 256


def _fit(nc, target):
    """Cells per box along an axis of ``nc`` cells near ``target``: the
    even split of ``nc`` into ceil(nc / target) boxes (the last box is
    the one short of the others, by less than a box)."""
    target = max(1, min(int(target), nc))
    return -(-nc // -(-nc // target))


def lattice_plan(nc, P, zb=None):
    """The box ``(Sx, By, Bz)`` in cells that a block of the lattice
    kernels owns and marches through along x, for ``nc`` cells at degree
    ``P``: `BOX` and `MARCH` fitted to the lattice (`_fit`). For 'zgrp'
    (z-group ``zb``) Bz is the largest divisor of ``zb`` up to three
    times the target whose block stays within `max_threads`, so that a
    box's z-runs of ``Gz`` never straddle a group."""
    ncx, ncy, ncz = (int(c) for c in nc)
    P = int(P)
    ty, tz = BOX[P]
    By = _fit(ncy, ty)
    if zb is None:
        Bz = _fit(ncz, tz)
    else:
        zb = int(zb)
        cap = max_threads(P, "lattice_apply_zgrp") // (By * (P + 1) ** 2)
        Bz = max(d for d in range(1, min(zb, 3 * tz, max(1, cap)) + 1)
                 if zb % d == 0)
    return (_fit(ncx, MARCH), By, Bz)


def load_kernels():
    """Build (once per source hash) and load the kernel library.

    Raises RuntimeError when there is no CUDA device, no ``nvcc`` or the
    build fails; never returns a stand-in.
    """
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    lib, BUILD_LOG = build_and_load(_SRC, "lattice_blocked", _find_nvcc)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lattice_apply_launch.argtypes = [vp] * 6 + [ci] * 8 + [vp]
    lib.lattice_apply_launch.restype = ci
    lib.lattice_apply_geom_launch.argtypes = [vp] * 7 + [ci] * 8 + [vp]
    lib.lattice_apply_geom_launch.restype = ci
    lib.lattice_apply_zgrp_launch.argtypes = [vp] * 6 + [ci] * 9 + [vp]
    lib.lattice_apply_zgrp_launch.restype = ci
    lib.lattice_scratch_bytes.argtypes = [ci] * 7 + [vp]
    lib.lattice_scratch_bytes.restype = ctypes.c_int64
    lib.lattice_blocks_per_sm.argtypes = [ci] * 4
    lib.lattice_blocks_per_sm.restype = ci
    _lib = lib
    return lib


def _check_common(x, bc_marker, D1, nc, P):
    if x.device.type != "cuda":
        raise ValueError(
            f"the lattice_blocked kernels run on CUDA tensors, got {x.device}")
    if P not in DEGREES:
        raise NotImplementedError(
            f"the lattice_blocked kernels are compiled for P in {DEGREES}, "
            f"got P={P}")
    N = tuple(c * P + 1 for c in nc)
    ndofs = N[0] * N[1] * N[2]
    if tuple(x.shape) not in ((ndofs,), N):
        raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                         f"({ndofs},) or {N}")
    _check("x", x, x.shape, x.device)
    _check("bc_marker", bc_marker, x.shape, x.device, torch.bool)
    _check("D1", D1, (P + 1, P + 1), x.device)
    return tuple(c * (P + 1) for c in nc)


def face_scratch_bytes(nc, P, box):
    """Bytes of the face scratch of ``box`` on ``nc`` cells at degree
    ``P`` and the threads of its face kernel (``lattice_scratch_bytes`` of
    the CUDA source, which owns the layout)."""
    faces = ctypes.c_int64(0)
    nbytes = load_kernels().lattice_scratch_bytes(
        int(P), *(int(c) for c in nc), *(int(s) for s in box),
        ctypes.byref(faces))
    if nbytes < 0:
        raise ValueError(f"no launch plan for box {tuple(box)} on {nc} "
                         f"cells at P={P}")
    return int(nbytes), faces.value


# Launch records: (nc, P, zb) -> (box, floats of the face scratch).
_RECORDS = {}


def _record(nc, P, zb=None):
    """The box (`lattice_plan`) of the lattice kernels on ``nc`` cells at
    degree ``P`` (z-group ``zb`` for 'zgrp') and the floats of its face
    scratch, worked out once."""
    key = (nc, P, zb)
    rec = _RECORDS.get(key)
    if rec is None:
        box = lattice_plan(nc, P, zb)
        rec = _RECORDS[key] = (box, max(1, face_scratch_bytes(nc, P, box)[0]
                                        // 4))
    return rec


def _scratch(floats, x):
    """A face scratch from the caching allocator on x's stream, for one
    launch: it needs no initial value, and no two calls share one."""
    return torch.empty(floats, dtype=torch.float32, device=x.device)


def _launched(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _cells(nc):
    return tuple(int(c) for c in nc)


def lattice_apply(x, bc_marker, Gt, D1, nc, P, apply_bc=True):
    """Launch K-A on CUDA tensors: ``A x`` (flat or lattice-shaped f32
    ``x``, bool ``bc_marker`` of the same shape, ``Gt`` ``(6, Qx, Qy,
    Qz)``, ``D1`` ``(P+1, P+1)``); returns a new tensor shaped like x."""
    nc = _cells(nc)
    Q = _check_common(x, bc_marker, D1, nc, P)
    _check("Gt", Gt, (6,) + Q, x.device)
    box, floats = _record(nc, P)
    out = torch.empty_like(x)
    scratch = _scratch(floats, x)
    with _on_device(x):
        rc = load_kernels().lattice_apply_launch(
            x.data_ptr(), bc_marker.data_ptr(), Gt.data_ptr(), D1.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), P, *nc, *box,
            int(bool(apply_bc)), stream_of(x))
    _launched("lattice_apply", rc)
    return out


def _check_zb(nc, zb):
    if zb <= 0 or nc[2] % zb:
        raise ValueError(f"zb={zb} must divide ncz={nc[2]}")


def lattice_apply_zgrp(x, bc_marker, Gz, D1, nc, P, zb, apply_bc=True):
    """Launch K-A on CUDA tensors with the z-grouped geometry ``Gz``
    ``(Qx, 6*ngz, Qy, zb*(P+1))`` of `geometry_to_zgrouped`; returns a new
    tensor shaped like x."""
    nc, zb = _cells(nc), int(zb)
    Qx, Qy, Qz = _check_common(x, bc_marker, D1, nc, P)
    _check_zb(nc, zb)
    zbn = zb * (P + 1)
    _check("Gz", Gz, (Qx, 6 * (Qz // zbn), Qy, zbn), x.device)
    box, floats = _record(nc, P, zb)
    out = torch.empty_like(x)
    scratch = _scratch(floats, x)
    with _on_device(x):
        rc = load_kernels().lattice_apply_zgrp_launch(
            x.data_ptr(), bc_marker.data_ptr(), Gz.data_ptr(), D1.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), P, *nc, zb, *box,
            int(bool(apply_bc)), stream_of(x))
    _launched("lattice_apply_zgrp", rc)
    return out


_GLL_DEVICE = {}


def _gll_table(xi, wx, device):
    """The (2, n) f32 table of GLL points and weights K-B reads, made once
    per device."""
    key = (tuple(xi), tuple(wx), str(device))
    if key not in _GLL_DEVICE:
        _GLL_DEVICE[key] = torch.tensor([xi, wx], dtype=torch.float32,
                                        device=device)
    return _GLL_DEVICE[key]


def lattice_apply_geom(x, bc_marker, co, D1, nc, P, xi, wx, apply_bc=True):
    """Launch K-B on CUDA tensors: ``A x`` with G rebuilt in the kernel
    from ``co`` ``(37, ncx, ncy, ncz)`` f32 and the GLL tuples ``xi``,
    ``wx``; returns a new tensor shaped like x."""
    nc = _cells(nc)
    _check_common(x, bc_marker, D1, nc, P)
    _check("co", co, (37,) + nc, x.device)
    if len(xi) != P + 1 or len(wx) != P + 1:
        raise ValueError(f"xi and wx must hold P+1 = {P + 1} values")
    gll = _gll_table(xi, wx, x.device)
    box, floats = _record(nc, P)
    out = torch.empty_like(x)
    scratch = _scratch(floats, x)
    with _on_device(x):
        rc = load_kernels().lattice_apply_geom_launch(
            x.data_ptr(), bc_marker.data_ptr(), co.data_ptr(), D1.data_ptr(),
            gll.data_ptr(), scratch.data_ptr(), out.data_ptr(), P, *nc, *box,
            int(bool(apply_bc)), stream_of(x))
    _launched("lattice_apply_geom", rc)
    return out


def blocks_per_sm(kernel, P, plan):
    """Blocks of ``kernel`` ('lattice_apply', 'lattice_apply_geom' or
    'lattice_apply_zgrp') one SM of the current card holds at degree ``P``
    on ``plan`` (the CUDA occupancy API)."""
    geo = {"lattice_apply": 0, "lattice_apply_geom": 1,
           "lattice_apply_zgrp": 2}[kernel]
    return load_kernels().lattice_blocks_per_sm(geo, P, plan[1], plan[2])


def _lattice_knobs(bcells, interpret):
    """The JAX entry points' keyword TPU knobs (``bcells=1,
    interpret=None``): their defaults only."""
    _tpu_knob("bcells", bcells, 1)
    _tpu_knob("interpret", interpret, None)


def blocked_lattice_apply(x, mats, Gt, bc_marker, nc, P, *, bcells=1,
                          precision="highest", interpret=None,
                          apply_bc=True, variant=None):
    """Fused ``y = A x`` on general hexes (shape-preserving). ``Gt`` is the
    ``(6, Qx, Qy, Qz)`` array of `geometry_to_gfirst`, ``mats`` from
    `lattice_blocked_mats`. ``variant`` in {None, 'yexp', 'v1', 'ym'}: the
    TPU layouts of one function, all K-A here. A CPU tensor runs the plain
    torch version (any float dtype); a CUDA tensor launches K-A (float32)
    or raises. The JAX package's TPU knobs ``bcells`` and ``interpret``
    take its defaults only."""
    _check_precision(precision)
    _lattice_knobs(bcells, interpret)
    if variant not in (None, "yexp", "v1", "ym"):
        raise ValueError(f"unknown variant {variant!r} (the in-kernel-"
                         "geometry 'geom' and z-grouped 'zgrp' variants "
                         "have their own entry points, "
                         "`blocked_lattice_apply_geom` and "
                         "`blocked_lattice_apply_zgrp`)")
    if x.device.type == "cpu":
        return plain_lattice_apply(x, mats, Gt, bc_marker, apply_bc)
    return lattice_apply(x, bc_marker, Gt, mats["D1"], tuple(nc), int(P),
                         apply_bc)


def blocked_lattice_apply_geom(x, mats, co, geom, bc_marker, nc, P, *, xi,
                               wx, bcells=1, precision="highest",
                               interpret=None, apply_bc=True):
    """Fused ``y = A x`` with in-kernel geometry: ``co`` is the (37, ncx,
    ncy, ncz) coefficient array, ``geom`` the expansion-matrix dict and
    ``xi``/``wx`` the GLL tuples from `lattice_geom_data` (the JAX
    signature; K-B rebuilds the expansion from ``xi`` itself, so ``geom``
    is not read). CPU tensors run the plain version; CUDA tensors launch
    K-B or raise. ``bcells`` and ``interpret`` as in
    `blocked_lattice_apply`."""
    _check_precision(precision)
    _lattice_knobs(bcells, interpret)
    if x.device.type == "cpu":
        return plain_lattice_apply_geom(x, mats, co, bc_marker, tuple(nc),
                                        int(P), apply_bc)
    return lattice_apply_geom(x, bc_marker, co, mats["D1"], tuple(nc),
                              int(P), xi, wx, apply_bc)


def blocked_lattice_apply_zgrp(x, mats, zmats, Gz, bc_marker, nc, P, zb, *,
                               bcells=1, precision="highest", interpret=None,
                               apply_bc=True):
    """Fused ``y = A x`` with the z-grouped geometry ``Gz`` of
    `geometry_to_zgrouped` (``zb`` must divide ``nc[2]``; `select_zgroup`
    picks it). ``zmats`` from `zgroup_matrices` keeps the JAX signature;
    the CUDA kernel does not need it. CPU tensors run the plain version;
    CUDA tensors launch K-A on ``Gz`` or raise. ``bcells`` and
    ``interpret`` as in `blocked_lattice_apply`."""
    _check_precision(precision)
    _lattice_knobs(bcells, interpret)
    nc, P, zb = tuple(nc), int(P), int(zb)
    _check_zb(nc, zb)
    if x.device.type == "cpu":
        return plain_lattice_apply_zgrp(x, mats, Gz, bc_marker, nc, P, zb,
                                        apply_bc)
    return lattice_apply_zgrp(x, bc_marker, Gz, mats["D1"], nc, P, zb,
                              apply_bc)


class PallasLatticeBlocked:
    """General-hex operator over the lattice kernels, float32, on
    ``device``: ``op(x)`` and the exact (dofmap) diagonal. ``variant``
    None/'yexp'/'v1'/'ym' streams the quadrature-lattice G (K-A); 'zgrp'
    streams the z-grouped ``Gz`` (K-A; ``zb`` from `select_zgroup` when
    not given; only ``Gz`` is kept, never G beside it); 'geom' uploads 37
    floats per cell and rebuilds G in the kernel (K-B). ``kappa`` is a
    scalar, a DG-0 per-cell field (K-B reads it at ``co[36]``) or a
    callable; a tensor folds into G (not with 'geom'). The parameters keep the JAX package's order; its TPU knobs
    ``bcells`` and ``interpret`` take their defaults only."""

    def __init__(self, mesh, P, kappa=2.0, bcells=1, interpret=False,
                 precision="highest", variant=None, zb=None, *, device):
        from ..fem.assembly import (
            geometry_factors_np,
            resolve_kappa_split,
            scale_G,
        )
        from ..fem.gll import derivative_matrix
        from .laplacian import laplacian_diagonal
        from .lattice import geometry_to_qlattice

        _check_precision(precision)
        _tpu_knob("bcells", bcells, 1)
        _tpu_knob("interpret", interpret, False)
        if variant not in (None, "yexp", "v1", "ym", "geom", "zgrp"):
            raise ValueError(f"unknown variant {variant!r}")
        self.zb = self.zmats = self.Gz = self.geom = None
        if variant == "zgrp":
            self.zb = int(zb) if zb else select_zgroup(mesh.nc[2], P)
            if self.zb is None:
                raise ValueError(
                    f"variant='zgrp': ncz={mesh.nc[2]} has no z-group "
                    "divisor that beats the dense z dots (see "
                    "select_zgroup) — use variant='yexp'")
            _check_zb(mesh.nc, self.zb)
        self.P = int(P)
        self.mesh = mesh
        self.ndofs = mesh.num_dofs(P)
        self.precision = precision
        self.variant = variant
        self.device = torch.device(device)
        f32 = lambda a: torch.tensor(a, dtype=torch.float32,
                                     device=self.device)
        kappa_cells, kt, _ = resolve_kappa_split(mesh, kappa)
        if kt is not None and variant == "geom":
            raise ValueError(
                "variant='geom' rebuilds geometry from scalar-kappa "
                "coefficients in-kernel; tensor kappa needs the "
                "G-streaming variants ('yexp'/'v1'/'zgrp')"
            )
        G_cells, _ = geometry_factors_np(mesh, self.P, kappa=kt)
        if variant == "geom":
            self.co = f32(lattice_geom_coefficients(mesh, self.P,
                                                    kappa_cells))
            self.geom, self._xi, self._wx = lattice_geom_data(
                mesh.nc, self.P, device=self.device)
            self.Gt = None
        elif variant == "zgrp":
            Gq = geometry_to_qlattice(scale_G(G_cells, kappa_cells, kt),
                                      mesh.nc, self.P)
            self.Gz = f32(geometry_to_zgrouped(Gq, self.zb, self.P))
            del Gq
            self.zmats = zgroup_matrices(self.zb, self.P, device=self.device)
            self.Gt = self.co = None
        else:
            Gq = geometry_to_qlattice(scale_G(G_cells, kappa_cells, kt),
                                      mesh.nc, self.P)
            self.Gt = f32(geometry_to_gfirst(Gq))
            self.co = None
        self.mats = lattice_blocked_mats(mesh.nc, self.P, device=self.device)
        self.bc_marker = torch.tensor(mesh.boundary_dof_marker(self.P),
                                      device=self.device)
        self.diag = laplacian_diagonal(
            torch.tensor(mesh.dofmap(self.P), dtype=torch.int64,
                         device=self.device),
            f32(G_cells), f32(kappa_cells), f32(derivative_matrix(self.P)),
            self.bc_marker, self.ndofs)
        self.diag_inv = 1.0 / self.diag

    def __call__(self, x):
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if self.variant == "geom":
            return blocked_lattice_apply_geom(
                x, self.mats, self.co, self.geom, self.bc_marker,
                self.mesh.nc, self.P, xi=self._xi, wx=self._wx,
                precision=self.precision)
        if self.variant == "zgrp":
            return blocked_lattice_apply_zgrp(
                x, self.mats, self.zmats, self.Gz, self.bc_marker,
                self.mesh.nc, self.P, self.zb, precision=self.precision)
        return blocked_lattice_apply(
            x, self.mats, self.Gt, self.bc_marker, self.mesh.nc, self.P,
            precision=self.precision, variant=self.variant)
