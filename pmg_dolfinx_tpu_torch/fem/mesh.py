"""Structured hexahedral box meshes with tensor-product dofmaps.

Port of `pmg_dolfinx_tpu.fem.mesh` (numpy, host-side): `BoxMesh` with
per-face Dirichlet flags, Robin faces (``robin``, per-face ``alpha``) and
graded spacing (``spacing``, `geometric_spacing`), `PerturbedBoxMesh`
(general curved hexes from smoothly displaced vertices, `default_warp`)
and `require_axis_aligned`.

Conventions (identical to the JAX package, so arrays compare bit for bit):
- cells:  ``cell = (cx * ny + cy) * nz + cz`` (x slowest, z fastest),
- local tensor-product dofs: ``local = (i * n + j) * n + k`` with
  ``n = P + 1``,
- global dofs: lattice id ``(gx * NY + gy) * NZ + gz`` on the
  ``(nx*P+1, ny*P+1, nz*P+1)`` node lattice, nodes at the mapped GLL
  points of each cell.
"""

from functools import lru_cache

import numpy as np

from .gll import gauss_lobatto


def _norm_robin_alpha(robin, dirichlet_faces):
    """Normalize the Robin spec to a read-only 3x2 float64 array of
    per-face coefficients ``alpha`` (0 = no Robin term on that face)."""
    if robin is None:
        out = np.zeros((3, 2))
    else:
        # a copy: setflags below must not freeze a caller's array
        out = np.array(robin, dtype=np.float64)
        if out.shape != (3, 2):
            raise ValueError(
                "robin must be a 3x2 nested sequence of per-face alpha "
                "coefficients ((x0,x1),(y0,y1),(z0,z1)); 0 disables a face"
            )
        if np.any(out < 0.0):
            raise ValueError("robin alpha coefficients must be >= 0")
        for a in range(3):
            for s in range(2):
                if out[a, s] > 0.0 and dirichlet_faces[a][s]:
                    raise ValueError(
                        f"face (axis={a}, side={s}) is flagged Dirichlet "
                        "AND Robin; a Robin face must be non-Dirichlet "
                        "(drop it from dirichlet_faces)"
                    )
    out.setflags(write=False)
    return out


def _norm_spacing(spacing, nc, extent):
    """Normalize the per-axis grading spec to absolute cell sizes.

    ``spacing`` is a 3-tuple; each entry is None (uniform axis) or a
    length-``nc[a]`` sequence of positive relative cell widths, scaled so
    the axis fills ``extent[a]``. Returns ``(h_cells, uniform)``: read-only
    float64 ``(nc_a,)`` arrays of absolute cell sizes, and the per-axis
    is-uniform flags (a constant spacing array counts as uniform)."""
    if spacing is None:
        spacing = (None, None, None)
    if len(spacing) != 3:
        raise ValueError("spacing must be a 3-tuple of per-axis entries "
                         "(None = uniform axis)")
    h_cells, uniform = [], []
    for a, (s, n, e) in enumerate(zip(spacing, nc, extent)):
        if s is None:
            h = np.full(n, e / n)
            uniform.append(True)
        else:
            s = np.asarray(s, dtype=np.float64)
            if s.shape != (n,):
                raise ValueError(
                    f"spacing[{a}] must have one width per cell "
                    f"(shape ({n},), got {s.shape})")
            if np.any(s <= 0.0):
                raise ValueError(f"spacing[{a}] widths must be positive")
            h = s * (e / s.sum())
            uniform.append(bool(np.allclose(h, h[0], rtol=1e-12)))
        h.setflags(write=False)
        h_cells.append(h)
    return tuple(h_cells), tuple(uniform)


def geometric_spacing(n, ratio):
    """Cell widths in geometric progression, smallest first: the last cell
    is ``ratio`` times the first (boundary-layer grading; pass, possibly
    reversed, as a `BoxMesh` ``spacing`` entry)."""
    if n < 1:
        raise ValueError("need at least one cell")
    if ratio <= 0:
        raise ValueError("ratio must be positive")
    return np.geomspace(1.0, float(ratio), n)


def _norm_dirichlet_faces(faces):
    """Normalize to a 3x2 nested bool tuple ((x0,x1),(y0,y1),(z0,z1))."""
    if faces is True or faces is None:
        return ((True, True),) * 3
    out = tuple(tuple(bool(e) for e in pair) for pair in faces)
    if len(out) != 3 or any(len(p) != 2 for p in out):
        raise ValueError(
            "dirichlet_faces must be a 3x2 nested sequence of bools "
            "((x0,x1),(y0,y1),(z0,z1))"
        )
    return out


class BoxMesh:
    """Structured box mesh of ``nx x ny x nz`` hexahedral cells.

    Parameters
    ----------
    nc : (int, int, int)
        Number of cells per direction.
    extent : (float, float, float)
        Physical box size.
    dirichlet_faces : 3x2 nested bools, optional
        Per-axis (low-face, high-face) Dirichlet flags; unflagged faces
        carry the homogeneous Neumann condition. Default: all six faces
        Dirichlet.
    robin : 3x2 nested floats, optional
        Per-face Robin coefficients ``alpha`` of ``kappa du/dn + alpha u =
        g`` (0 = none; a Robin face must not be Dirichlet).
    spacing : 3-tuple, optional
        Per-axis None (uniform) or relative cell widths (graded).
    """

    def __init__(self, nc, extent=(1.0, 1.0, 1.0), dirichlet_faces=True,
                 robin=None, spacing=None):
        self.nc = tuple(int(v) for v in nc)
        self.extent = tuple(float(v) for v in extent)
        if any(v < 1 for v in self.nc):
            raise ValueError("need at least one cell per direction")
        self.ncells = self.nc[0] * self.nc[1] * self.nc[2]
        self.h_cells, self._uniform = _norm_spacing(spacing, self.nc,
                                                    self.extent)
        self.dirichlet_faces = _norm_dirichlet_faces(dirichlet_faces)
        self.robin_alpha = _norm_robin_alpha(robin, self.dirichlet_faces)

    @property
    def h(self) -> tuple:
        """Per-axis uniform cell size; raises ValueError on a graded mesh
        (use ``h_cells``)."""
        if not all(self._uniform):
            raise ValueError(
                "mesh is graded (non-uniform spacing); there is no "
                "single per-axis h — use mesh.h_cells"
            )
        return tuple(float(hc[0]) for hc in self.h_cells)

    @property
    def is_graded(self) -> bool:
        """True when any axis carries non-uniform cell spacing."""
        return not all(self._uniform)

    @property
    def has_robin(self) -> bool:
        """True when any face carries a Robin term (alpha > 0)."""
        return bool(np.any(self.robin_alpha > 0.0))

    @lru_cache(maxsize=None)
    def axis_nodes(self, a: int) -> np.ndarray:
        """1D node coordinates along axis ``a``, shape ``(nc_a + 1,)``."""
        out = np.concatenate(([0.0], np.cumsum(self.h_cells[a])))
        out[-1] = self.extent[a]  # exact despite fp summation
        out.setflags(write=False)
        return out

    @property
    def geometry_x(self) -> np.ndarray:
        """Corner-node coordinates, shape ``(n_geom_nodes, 3)`` float64."""
        return self._geometry_x()

    @lru_cache(maxsize=1)
    def _geometry_x(self):
        X, Y, Z = np.meshgrid(self.axis_nodes(0), self.axis_nodes(1),
                              self.axis_nodes(2), indexing="ij")
        out = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)
        out.setflags(write=False)
        return out

    @property
    def geometry_dofmap(self) -> np.ndarray:
        """Cell -> corner-node map, shape ``(ncells, 8)`` int32."""
        return self._geometry_dofmap()

    @lru_cache(maxsize=1)
    def _geometry_dofmap(self):
        return self.dofmap(1).astype(np.int32)

    def lattice_shape(self, P: int) -> tuple[int, int, int]:
        return tuple(n * P + 1 for n in self.nc)

    def num_dofs(self, P: int) -> int:
        NX, NY, NZ = self.lattice_shape(P)
        return NX * NY * NZ

    @lru_cache(maxsize=None)
    def dofmap(self, P: int) -> np.ndarray:
        """Cell dofmap, shape ``(ncells, (P+1)^3)`` int32, tensor-product
        order."""
        nx, ny, nz = self.nc
        NX, NY, NZ = self.lattice_shape(P)
        n = P + 1
        cx = np.arange(nx)[:, None, None, None, None, None]
        cy = np.arange(ny)[None, :, None, None, None, None]
        cz = np.arange(nz)[None, None, :, None, None, None]
        i = np.arange(n)[None, None, None, :, None, None]
        j = np.arange(n)[None, None, None, None, :, None]
        k = np.arange(n)[None, None, None, None, None, :]
        gid = ((cx * P + i) * NY + (cy * P + j)) * NZ + (cz * P + k)
        out = np.ascontiguousarray(
            np.broadcast_to(gid, (nx, ny, nz, n, n, n)).reshape(self.ncells, n**3)
        ).astype(np.int32)
        out.setflags(write=False)
        return out

    @lru_cache(maxsize=None)
    def dof_coords(self, P: int) -> np.ndarray:
        """Physical coordinates of all dofs, shape ``(ndofs, 3)``."""
        xg, _ = gauss_lobatto(P + 1)
        axes = []
        for d in range(3):
            ncd = self.nc[d]
            g = np.arange(ncd * P + 1)
            c = np.minimum(g // P, ncd - 1)
            i = g - c * P
            axes.append(self.axis_nodes(d)[c] + xg[i] * self.h_cells[d][c])
        X, Y, Z = np.meshgrid(*axes, indexing="ij")
        out = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)
        out.setflags(write=False)
        return out

    @lru_cache(maxsize=None)
    def boundary_dof_marker(self, P: int) -> np.ndarray:
        """Boolean marker of the Dirichlet dofs, shape ``(ndofs,)``;
        honors ``dirichlet_faces``."""
        m = np.zeros(self.lattice_shape(P), dtype=bool)
        for a, (lo, hi) in enumerate(self.dirichlet_faces):
            sl = [slice(None)] * 3
            if lo:
                sl[a] = 0
                m[tuple(sl)] = True
            if hi:
                sl[a] = -1
                m[tuple(sl)] = True
        out = m.ravel()
        out.setflags(write=False)
        return out

    @lru_cache(maxsize=None)
    def dof_multiplicity(self, P: int) -> np.ndarray:
        """Number of cells sharing each dof, shape ``(ndofs,)`` float64
        (weights the fine residual in the dofmap restriction)."""
        mult = np.ones(1, dtype=np.float64)
        for d in range(3):
            ncd = self.nc[d]
            g = np.arange(ncd * P + 1)
            on_interface = (g % P == 0) & (g > 0) & (g < ncd * P)
            md = np.where(on_interface, 2.0, 1.0)
            mult = np.multiply.outer(mult, md)
        out = np.ascontiguousarray(mult.reshape(self.num_dofs(P)))
        out.setflags(write=False)
        return out

    def cell_centroids(self) -> np.ndarray:
        """Cell centroids ``(ncells, 3)`` in dofmap cell order: the mean of
        the 8 corners (exact for the trilinear geometry)."""
        return self.geometry_x[self.geometry_dofmap].mean(axis=1)

    # Every cell Jacobian is diagonal-constant (the Kronecker / FDM paths
    # require this; general hexes use the lattice/dofmap backends).
    is_axis_aligned = True

    def __repr__(self):
        g = ", graded" if self.is_graded else ""
        return f"BoxMesh(nc={self.nc}, extent={self.extent}{g})"


def require_axis_aligned(mesh, what: str):
    """Guard for the Kronecker/FDM fast paths (diagonal-Jacobian only)."""
    if not getattr(mesh, "is_axis_aligned", True):
        raise ValueError(
            f"{what} requires an axis-aligned BoxMesh (diagonal Jacobians);"
            " use the 'lattice' or 'dofmap' backend for general hexes"
        )


def default_warp(amplitude=0.08):
    """Smooth interior-bubble displacement vanishing on the unit cube's
    boundary: every interior cell becomes a genuine (non-affine) hex while
    the domain stays exactly the unit cube."""

    def warp(x):
        bx = np.sin(np.pi * x[0])
        by = np.sin(np.pi * x[1])
        bz = np.sin(np.pi * x[2])
        b = bx * by * bz
        return amplitude * np.stack([
            b * np.cos(np.pi * x[1]),
            b * np.cos(np.pi * x[2]),
            b * np.cos(np.pi * x[0]),
        ])

    return warp


class PerturbedBoxMesh(BoxMesh):
    """Structured-topology mesh with smoothly displaced vertices: trilinear
    (Q1) general hexahedral cells (non-diagonal Jacobians, all 6 G
    entries). ``warp(x[(3, npts)]) -> displacement[(3, npts)]`` moves the
    corner vertices only; higher-order dof coordinates follow the Q1 map.
    The Kronecker/FDM paths reject it (``is_axis_aligned = False``).
    """

    is_axis_aligned = False

    def __init__(self, nc, extent=(1.0, 1.0, 1.0), warp=None,
                 dirichlet_faces=True, robin=None, spacing=None):
        super().__init__(nc, extent, dirichlet_faces=dirichlet_faces,
                         robin=robin, spacing=spacing)
        self._warp = warp if warp is not None else default_warp()

    @lru_cache(maxsize=1)
    def _geometry_x(self):
        base = super()._geometry_x()
        disp = np.asarray(self._warp(base.T), dtype=np.float64).T
        out = base + disp
        out.setflags(write=False)
        return out

    @lru_cache(maxsize=None)
    def dof_coords(self, P: int) -> np.ndarray:
        """Dof coordinates through the Q1 geometry map (per-cell trilinear
        interpolation of the displaced corners at the reference GLL
        points; consistent across shared faces)."""
        xg, _ = gauss_lobatto(P + 1)
        n = P + 1
        phi1 = np.stack([1.0 - xg, xg], axis=1)  # (n, 2)
        N = np.einsum("qa,rb,sc->qrsabc", phi1, phi1, phi1).reshape(
            n**3, 8
        )
        corners = self.geometry_x[self.geometry_dofmap]  # (ncells, 8, 3)
        coords_cells = np.einsum("qa,caD->cqD", N, corners)
        out = np.zeros((self.num_dofs(P), 3))
        out[self.dofmap(P).ravel()] = coords_cells.reshape(-1, 3)
        out.setflags(write=False)
        return out

    def __repr__(self):
        return f"PerturbedBoxMesh(nc={self.nc}, extent={self.extent})"
