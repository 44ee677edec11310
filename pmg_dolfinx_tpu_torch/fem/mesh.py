"""Structured hexahedral box meshes with tensor-product dofmaps.

Port of `pmg_dolfinx_tpu.fem.mesh` (numpy, host-side): `BoxMesh` with
per-face Dirichlet flags, `PerturbedBoxMesh` (general curved hexes from
smoothly displaced vertices, `default_warp`) and `require_axis_aligned`.
Graded spacing and Robin faces are not ported yet (ROADMAP.md, Queue 1
item 7).

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
    """Structured box mesh of ``nx x ny x nz`` uniform hexahedral cells.

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
    """

    def __init__(self, nc, extent=(1.0, 1.0, 1.0), dirichlet_faces=True):
        self.nc = tuple(int(v) for v in nc)
        self.extent = tuple(float(v) for v in extent)
        if any(v < 1 for v in self.nc):
            raise ValueError("need at least one cell per direction")
        self.ncells = self.nc[0] * self.nc[1] * self.nc[2]
        h_cells = []
        for n, e in zip(self.nc, self.extent):
            h = np.full(n, e / n)
            h.setflags(write=False)
            h_cells.append(h)
        self.h_cells = tuple(h_cells)
        self.dirichlet_faces = _norm_dirichlet_faces(dirichlet_faces)

    @property
    def is_graded(self) -> bool:
        """True when an axis carries non-uniform cell spacing: never, until
        graded spacing is ported (ROADMAP.md Queue 1 item 7c)."""
        return False

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
        return f"BoxMesh(nc={self.nc}, extent={self.extent})"


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
                 dirichlet_faces=True):
        super().__init__(nc, extent, dirichlet_faces=dirichlet_faces)
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
