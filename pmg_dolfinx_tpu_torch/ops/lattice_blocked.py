"""General-hex (curved) apply: hand-written CUDA kernels and their plain
torch versions.

Port of `pmg_dolfinx_tpu.ops.pallas_lattice_blocked`:

- host setup, as in the JAX package: `lattice_blocked_mats`,
  `geometry_to_gfirst`, `lattice_geom_coefficients`, `lattice_geom_data`
  and `geom_to_G` (numpy float64, or torch for the plain version);
- `blocked_lattice_apply` (variants 'yexp', 'v1', 'ym') and
  `blocked_lattice_apply_geom` ('geom') — the entry points. On a CPU
  tensor they run the plain torch version; on a CUDA tensor they launch
  the kernels of `csrc/lattice_blocked.cu` or raise. There is no fallback
  from CUDA to the plain version. The three TPU variants lay the same
  ``y = A x`` out differently over VMEM and the MXU, so all three launch
  one kernel here (K-A, `lattice_apply`); 'geom' launches K-B
  (`lattice_apply_geom`), which rebuilds G in the kernel from 37 floats
  per cell;
- `plain_lattice_apply` / `plain_lattice_apply_geom` — the JAX package's
  emulation path (`lattice_laplacian_apply` on ``moveaxis(Gt, 0, -1)``,
  or on `geom_to_G` of the coefficients), used by the CPU tests and
  compared with the kernels on the card by `chip_smoke.py`;
- `PallasLatticeBlocked` — the operator bundle (apply + exact diagonal).

The kernels are built with ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/`` (`ops.cuda_build`) and bound through a plain C
interface with `ctypes`. `LAUNCHES` counts every kernel launch.

Not ported: the z-grouped variant 'zgrp' (ROADMAP.md Queue 2, kernel
#16), ``precision="high"`` (bf16x3), and the TPU tile knobs ``bcells``
and ``interpret``.
"""

import ctypes
from pathlib import Path

import numpy as np
import torch

from .cuda_build import build_and_load
from .cuda_build import check_operand as _check
from .cuda_build import find_nvcc as _find_nvcc
from .cuda_build import ptr as _ptr
from .cuda_build import stream_of
from .kron_blocked import _check_precision
from .lattice import axis_matrices, lattice_laplacian_apply

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "lattice_blocked.cu"

# Kernel launches since the last reset: kernel name -> count. Raised only
# where a wrapper launches its kernel.
LAUNCHES = {"lattice_apply": 0, "lattice_apply_geom": 0}

# Degrees the kernels are compiled for (csrc/lattice_blocked.cu, N = P+1).
DEGREES = (1, 2, 3, 4, 5, 6)

# The loaded library and the compiler's output of the build that made it.
_lib = None
BUILD_LOG = ""

_ZGRP_TODO = ("the z-grouped lattice kernel _kernel_lattice_zg (variant "
              "'zgrp') is not ported yet (ROADMAP.md Queue 2, kernel #16)")
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


def geom_to_G(co, nc, P):
    """Quadrature-lattice geometry ``(Qx, Qy, Qz, 6)`` rebuilt from the
    coefficient grids: numpy float64 for a numpy ``co``, torch in
    ``co``'s dtype and device for a tensor (the plain version of K-B)."""
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


def plain_lattice_apply_geom(x, mats, co, bc_marker, nc, P, apply_bc=True):
    """K-B's function: `geom_to_G` of the coefficients, then
    `lattice_laplacian_apply`."""
    return lattice_laplacian_apply(
        x, {k: mats[k] for k in _MATS_PLAIN}, geom_to_G(co, nc, P),
        bc_marker, apply_bc=apply_bc)


# --- CUDA kernels -------------------------------------------------------------

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
    lib.lattice_apply_launch.argtypes = [vp] * 6 + [ci] * 5 + [vp]
    lib.lattice_apply_launch.restype = ci
    lib.lattice_apply_geom_launch.argtypes = [vp] * 7 + [ci] * 5 + [vp]
    lib.lattice_apply_geom_launch.restype = ci
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


def lattice_apply(x, bc_marker, Gt, D1, nc, P, apply_bc=True):
    """Launch K-A on CUDA tensors: ``A x`` (flat or lattice-shaped f32
    ``x``, bool ``bc_marker`` of the same shape, ``Gt`` ``(6, Qx, Qy,
    Qz)``, ``D1`` ``(P+1, P+1)``); returns a new tensor shaped like x."""
    Q = _check_common(x, bc_marker, D1, nc, P)
    _check("Gt", Gt, (6,) + Q, x.device)
    lib = load_kernels()
    out = torch.empty_like(x)
    ycells = torch.empty(Q, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.lattice_apply_launch(
            _ptr(x), _ptr(bc_marker), _ptr(Gt), _ptr(D1), _ptr(ycells),
            _ptr(out), P, *nc, int(bool(apply_bc)), stream_of(x))
    if rc != 0:
        raise RuntimeError(f"lattice_apply launch failed: CUDA error {rc}")
    LAUNCHES["lattice_apply"] += 1
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
    Q = _check_common(x, bc_marker, D1, nc, P)
    _check("co", co, (37,) + tuple(nc), x.device)
    if len(xi) != P + 1 or len(wx) != P + 1:
        raise ValueError(f"xi and wx must hold P+1 = {P + 1} values")
    gll = _gll_table(xi, wx, x.device)
    lib = load_kernels()
    out = torch.empty_like(x)
    ycells = torch.empty(Q, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.lattice_apply_geom_launch(
            _ptr(x), _ptr(bc_marker), _ptr(co), _ptr(D1), _ptr(gll),
            _ptr(ycells), _ptr(out), P, *nc, int(bool(apply_bc)),
            stream_of(x))
    if rc != 0:
        raise RuntimeError(
            f"lattice_apply_geom launch failed: CUDA error {rc}")
    LAUNCHES["lattice_apply_geom"] += 1
    return out


def blocked_lattice_apply(x, mats, Gt, bc_marker, nc, P, *,
                          precision="highest", apply_bc=True, variant=None):
    """Fused ``y = A x`` on general hexes (shape-preserving). ``Gt`` is the
    ``(6, Qx, Qy, Qz)`` array of `geometry_to_gfirst`, ``mats`` from
    `lattice_blocked_mats`. ``variant`` in {None, 'yexp', 'v1', 'ym'}: the
    TPU layouts of one function, all K-A here. A CPU tensor runs the plain
    torch version (any float dtype); a CUDA tensor launches K-A (float32)
    or raises."""
    _check_precision(precision)
    if variant == "zgrp":
        raise NotImplementedError(_ZGRP_TODO)
    if variant not in (None, "yexp", "v1", "ym"):
        raise ValueError(f"unknown variant {variant!r} (the in-kernel-"
                         "geometry 'geom' variant has its own entry point, "
                         "`blocked_lattice_apply_geom`)")
    if x.device.type == "cpu":
        return plain_lattice_apply(x, mats, Gt, bc_marker, apply_bc)
    return lattice_apply(x, bc_marker, Gt, mats["D1"], tuple(nc), int(P),
                         apply_bc)


def blocked_lattice_apply_geom(x, mats, co, bc_marker, nc, P, *, xi, wx,
                               precision="highest", apply_bc=True):
    """Fused ``y = A x`` with in-kernel geometry: ``co`` is the (37, ncx,
    ncy, ncz) coefficient array, ``xi``/``wx`` the GLL tuples from
    `lattice_geom_data`. CPU tensors run the plain version; CUDA tensors
    launch K-B or raise."""
    _check_precision(precision)
    if x.device.type == "cpu":
        return plain_lattice_apply_geom(x, mats, co, bc_marker, tuple(nc),
                                        int(P), apply_bc)
    return lattice_apply_geom(x, bc_marker, co, mats["D1"], tuple(nc),
                              int(P), xi, wx, apply_bc)


def blocked_lattice_apply_zgrp(*args, **kwargs):
    raise NotImplementedError(_ZGRP_TODO)


class PallasLatticeBlocked:
    """General-hex operator over the lattice kernels, float32, on
    ``device``: ``op(x)`` and the exact (dofmap) diagonal. ``variant``
    None/'yexp'/'v1'/'ym' streams the quadrature-lattice G (K-A);
    'geom' uploads 37 floats per cell and rebuilds G in the kernel (K-B).
    ``kappa`` is a scalar."""

    def __init__(self, mesh, P, kappa=2.0, precision="highest", variant=None,
                 *, device):
        from ..fem.assembly import (
            geometry_factors_np,
            resolve_kappa_split,
            scale_G,
        )
        from ..fem.gll import derivative_matrix
        from .laplacian import laplacian_diagonal
        from .lattice import geometry_to_qlattice

        _check_precision(precision)
        if variant == "zgrp":
            raise NotImplementedError(_ZGRP_TODO)
        if variant not in (None, "yexp", "v1", "ym", "geom"):
            raise ValueError(f"unknown variant {variant!r}")
        self.P = int(P)
        self.mesh = mesh
        self.ndofs = mesh.num_dofs(P)
        self.precision = precision
        self.variant = variant
        self.device = torch.device(device)
        f32 = lambda a: torch.tensor(a, dtype=torch.float32,
                                     device=self.device)
        kappa_cells, kt, _ = resolve_kappa_split(mesh, kappa)
        G_cells, _ = geometry_factors_np(mesh, self.P, kappa=kt)
        if variant == "geom":
            self.co = f32(lattice_geom_coefficients(mesh, self.P,
                                                    kappa_cells))
            _, self._xi, self._wx = lattice_geom_data(mesh.nc, self.P,
                                                      device="cpu")
            self.Gt = None
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
                x, self.mats, self.co, self.bc_marker, self.mesh.nc, self.P,
                xi=self._xi, wx=self._wx, precision=self.precision)
        return blocked_lattice_apply(
            x, self.mats, self.Gt, self.bc_marker, self.mesh.nc, self.P,
            precision=self.precision, variant=self.variant)
