"""Distributed Fast Diagonalization: the exact direct solver on a sharded
layout, without gathering the lattice.

Port of `pmg_dolfinx_tpu.parallel.fdm_dist`. The single-device FDM
(`solvers.fdm`) is six per-axis dense contractions and a pointwise
division. A contraction along a SHARDED lattice axis needs that axis
whole on one shard, so each one is a pencil transpose:

    for each sharded lattice axis a (per transform sweep):
      1. zero-pad a "buddy" lattice axis to a multiple of the shard count,
         split it, and all_to_all along a's grid axis concatenating along
         a: axis a is now whole on every shard and the buddy axis 1/n as
         long, so memory stays O(N/n);
      2. drop the duplicated interface planes (the received windows
         overlap by one plane, the layout of `SlabPartition` /
         `GridPartition`);
      3. contract the full-size per-axis eigenvector matrix;
      4. put the duplicated planes back and all_to_all back.

Unsharded axes are plain local contractions, as in `fdm_solve`. The
eigenvalue-sum reciprocal ``dinv`` lives in the duplicated-plane layout,
and the per-axis transforms are BOUNDARY-EMBEDDED (zero rows and columns
at the Dirichlet end planes), so every shard runs the same program
whether or not it holds a global boundary plane. Results equal the
single-device `fdm_solve` to rounding: the embedded zeros only add exact
zero terms to the same sums.

Layout. The port stacks every shard on one device (`grid2d.StackedGrid`),
or each rank's block of them (`multihost.RankGrid`): a distributed lattice
is ONE tensor ``(sx, sy, sz, nplx, nply, nplz)`` (the block's leading
shape on a rank; a slab of `DistPMG` is the same memory as ``(S, npl, NY,
NZ)``). Every transpose goes through the solver's grid's `all_to_all`
(never a grid made from a tensor's shape, which on a rank would keep the
transpose inside it); two per sharded axis per sweep, at most 12 per
solve. No path here gathers the lattice. The host data are float64
numpy, as in the JAX package; the contractions are `torch.einsum` (TF32
off, as everywhere in the port).
"""

from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ..fem.assembly import resolve_kappa_axes
from ..solvers.fdm import _axis_eig

# Per-axis contraction strings, over the stacked layout's leading shard
# axes (solvers.fdm.fdm_solve's, batched).
_AXIS_EINSUM = ("ax,...xyz->...ayz", "by,...xyz->...xbz",
                "cz,...xyz->...xyc")


def _embed_boundary(V, ends=(True, True)):
    """Free-node matrix -> full-size with zero rows/cols at the
    Dirichlet-flagged ends (natural-Neumann ends are free nodes)."""
    n = V.shape[0]
    lo, hi = int(ends[0]), int(ends[1])
    M = np.zeros((n + lo + hi, n + lo + hi), dtype=V.dtype)
    M[lo:lo + n, lo:lo + n] = V
    return M


def _dedup(x, dim, n_sh, npl):
    """Concat of ``n_sh`` duplicated-plane windows along tensor axis
    ``dim`` -> the global axis. Window ``s`` covers global planes
    ``[s*(npl-1), s*(npl-1)+npl)``; each window's last plane is dropped
    except the final window's."""
    parts = [x.narrow(dim, s * npl, npl - 1) for s in range(n_sh - 1)]
    parts.append(x.narrow(dim, (n_sh - 1) * npl, npl))
    return torch.cat(parts, dim=dim)


def _redup(x, dim, n_sh, npl):
    """The global axis ``dim`` -> the concat of ``n_sh`` duplicated-plane
    windows."""
    return torch.cat([x.narrow(dim, s * (npl - 1), npl)
                      for s in range(n_sh)], dim=dim)


def _shards_of(axes_spec):
    return tuple(1 if spec is None else int(spec[1]) for spec in axes_spec)


def _transform_sharded(x, M, dim, axis_name, n_sh, precision, *, grid):
    """Per-axis transform along a sharded lattice axis of the stacked
    ``x`` (``grid``'s block): transpose in (all_to_all across the whole
    row of shards, other ranks' included), dedup, contract, redup,
    transpose out."""
    from .grid2d import AXES

    d = 3 + dim
    npl = x.shape[d]
    # Buddy = the longest other LOCAL axis (least relative zero-padding).
    buddy = max((k for k in range(3) if k != dim),
                key=lambda k: (x.shape[3 + k], -k))
    pad = (-x.shape[3 + buddy]) % n_sh
    if pad:
        widths = [0, 0] * 3
        widths[2 * (2 - buddy) + 1] = pad      # F.pad runs last axis first
        x = F.pad(x, widths)
    axis = AXES.index(axis_name)
    x = grid.all_to_all(x, axis, buddy, dim)
    x = _dedup(x, d, n_sh, npl)
    x = torch.einsum(_AXIS_EINSUM[dim], M, x)
    x = _redup(x, d, n_sh, npl)
    x = grid.all_to_all(x, axis, dim, buddy)
    if pad:
        x = x.narrow(3 + buddy, 0, x.shape[3 + buddy] - pad)
    return x


def _axis_transform(x, M, dim, spec, precision, *, grid):
    if spec is None:  # lattice axis unsharded: plain local contraction
        return torch.einsum(_AXIS_EINSUM[dim], M, x)
    axis_name, n_sh = spec
    return _transform_sharded(x, M, dim, axis_name, n_sh, precision,
                              grid=grid)


def fdm_solve_dist(fd, b, local_shape, axes_spec, precision="highest", *,
                   grid=None):
    """Exact solve ``u = A^{-1} b`` on the stacked layout
    (shape-preserving).

    ``fd``: the dict of `make_fdm_dist` (embedded per-axis eigenvector
    matrices, ``dinv`` and ``bc`` in the stacked layout). ``axes_spec``:
    per lattice axis ``None`` (unsharded) or ``(grid_axis_name,
    n_shards)``. ``b`` is any tensor holding the stacked lattice (the
    grid's six dimensions, a slab's ``(S, npl, NY, NZ)`` or flat); the
    output has its shape, with ``u[bc] = b[bc]`` identity rows as every
    backend. ``precision`` is the JAX package's (either value, in f32/f64:
    the XLA-path rule of `ops.kron_blocked`).
    ``grid`` is the layout's communication object (default: every shard
    of ``axes_spec`` stacked here; a rank's `multihost.RankGrid`, whose
    block is the leading shape of ``b``)."""
    from ..ops.kron_blocked import _check_precision
    from .grid2d import StackedGrid

    _check_precision(precision)
    if grid is None:
        grid = StackedGrid(_shards_of(axes_spec))
    x = b.reshape(grid.block + tuple(local_shape))
    for dim, M in enumerate((fd["Vxt"], fd["Vyt"], fd["Vzt"])):
        x = _axis_transform(x, M, dim, axes_spec[dim], precision, grid=grid)
    x = x * fd["dinv"]
    for dim, M in enumerate((fd["Vx"], fd["Vy"], fd["Vz"])):
        x = _axis_transform(x, M, dim, axes_spec[dim], precision, grid=grid)
    return torch.where(fd["bc"].reshape(b.shape), b, x.reshape(b.shape))


def _stacked(part, Pdeg, arr, dtype, device):
    """A host array in JAX's duplicated layout (`SlabPartition.to_dist`'s
    ``(S*npl, NY, NZ)`` or `GridPartition.to_dist`'s) -> the stacked
    six-dimensional layout on ``device``."""
    from .grid2d import stack_shards
    from .partition import SlabPartition

    t = torch.as_tensor(np.ascontiguousarray(arr), device=device)
    if dtype is not None:
        t = t.to(dtype)
    if isinstance(part, SlabPartition):
        return t.reshape((part.n_shards, 1, 1) + part.local_shape(Pdeg))
    return stack_shards(t, part.shards)


def _axis_data(mesh, faces, kax, Pdeg, forward):
    """Per-axis embedded (V, V^T) pairs and eigenvalues: the solve's
    ``V`` (``V^T M V = I``) or, ``forward``, the operator's mass-weighted
    ``M V`` / ``V^T M``."""
    from ..ops.kron import axis_stiffness_mass, robin_axis_ends

    Vs, Vts, lams = [], [], []
    for a, (nc_a, h_a, ends, k_a) in enumerate(
            zip(mesh.nc, mesh.h_cells, faces, kax)):
        # Robin end terms ride the kappa-free 1D eigenproblem with the
        # 1/k_a pre-divide (d sums k_a * lam, as in solvers/fdm.py).
        rob = robin_axis_ends(mesh, a, 1.0 / k_a)
        V, lam = _axis_eig(nc_a, Pdeg, h_a, ends=ends, robin=rob)
        if forward:
            _, m = axis_stiffness_mass(nc_a, Pdeg, h_a, robin=rob)
            mi = m[(1 if ends[0] else 0):(-1 if ends[1] else None)]
            Vs.append(mi[:, None] * V)
            Vts.append(V.T * mi[None, :])
        else:
            Vs.append(V)
            Vts.append(V.T)
        lams.append(lam)
    return Vs, Vts, lams


def _bundle(mesh, Pdeg, part, axes_spec, kappa, dtype, precision, sigma,
            device, forward, *, grid=None):
    from ..fem.mesh import require_axis_aligned
    from ..ops.kron_blocked import _check_precision

    _check_precision(precision)
    require_axis_aligned(mesh, "distributed FDM apply" if forward
                         else "distributed FDM")
    faces = getattr(mesh, "dirichlet_faces", ((True, True),) * 3)
    kx, ky, kz = kax = resolve_kappa_axes(mesh, kappa)
    Vs, Vts, lams = _axis_data(mesh, faces, kax, Pdeg, forward)
    if not forward:
        dmin = (kx * float(lams[0].min()) + ky * float(lams[1].min())
                + kz * float(lams[2].min())) + float(sigma)
        if dmin <= 1e-14:
            raise ValueError(
                "distributed FDM: singular operator (no Dirichlet face and "
                "sigma=0 leaves the constant nullspace); add a Dirichlet "
                "face or a positive sigma shift"
            )
    # Dirichlet slots: 1.0 in the solve (the embedded transforms zero those
    # rows, the value only keeps 1/d finite), 0.0 in the forward apply.
    le = []
    for lam, ends in zip(lams, faces):
        lo, hi = int(ends[0]), int(ends[1])
        e = (np.zeros if forward else np.ones)(lam.shape[0] + lo + hi)
        e[lo:lo + lam.shape[0]] = lam
        le.append(e)
    d = (kx * le[0][:, None, None] + ky * le[1][None, :, None]
         + kz * le[2][None, None, :]) + float(sigma)
    bc = np.asarray(mesh.boundary_dof_marker(Pdeg), dtype=np.float64)
    mat = lambda M, ends: torch.as_tensor(_embed_boundary(M, ends),
                                          dtype=dtype, device=device)
    data = dict(
        Vx=mat(Vs[0], faces[0]), Vy=mat(Vs[1], faces[1]),
        Vz=mat(Vs[2], faces[2]),
        Vxt=mat(Vts[0], faces[0]), Vyt=mat(Vts[1], faces[1]),
        Vzt=mat(Vts[2], faces[2]),
        dinv=_stacked(part, Pdeg, part.to_dist(Pdeg, d if forward
                                               else 1.0 / d), dtype, device),
        bc=_stacked(part, Pdeg, part.to_dist(Pdeg, bc), None, device) > 0.5,
    )
    solve = partial(fdm_solve_dist, local_shape=tuple(part.local_shape(Pdeg)),
                    axes_spec=tuple(axes_spec), precision=precision,
                    grid=grid)
    return data, solve


def _spec(lat_spec):
    """The layout of each array of a bundle (JAX's PartitionSpec tree): the
    grid axes it is stacked over, ``()`` for replicated."""
    return dict(Vx=(), Vy=(), Vz=(), Vxt=(), Vyt=(), Vzt=(),
                dinv=tuple(lat_spec), bc=tuple(lat_spec))


def make_fdm_dist(mesh, Pdeg, part, axes_spec, lat_spec, kappa, dtype,
                  precision="highest", sigma=0.0, *, device, grid=None):
    """The distributed-FDM bundle of one partition layout.

    ``part`` is a `SlabPartition` or `GridPartition`, ``axes_spec`` the
    per-lattice-axis ``(grid_axis_name, n_shards) | None`` tuple and
    ``lat_spec`` the grid axes a lattice is stacked over (``("x",)`` on the
    slab, ``("x", "y", "z")`` on grids; `dist_layout`). Returns ``(data,
    spec, solve)``: the tensors on ``device``, their layout tree and
    ``solve(fd, b)``, the hook `v_cycle` takes as ``ops["fdm_dist"]`` (or
    a whole-problem direct solve), communicating through ``grid`` (default:
    every shard stacked here). The tensors are the whole stack; a rank
    takes its block by ``spec`` (`multihost.put_tree`)."""
    data, solve = _bundle(mesh, Pdeg, part, axes_spec, kappa, dtype,
                          precision, sigma, device, forward=False, grid=grid)
    return data, _spec(lat_spec), solve


def dist_layout(mesh, shards, devices=None, *, device="cuda"):
    """Resolve ``shards`` (int = x-slab, 3-tuple = device grid) to the
    layout quadruple ``(part, grid, axes_spec, lat_spec)`` of `DistFDM` and
    the forward-apply bundles: the partition, the communication object (in
    place of JAX's device mesh: the `StackedGrid` that holds every shard
    on ``device``, or with a process group up this rank's
    `multihost.RankGrid` over the ranks ``devices`` names), the
    per-lattice-axis spec and the grid axes a lattice is stacked over."""
    from .grid2d import AXES, GridPartition, _norm_shards
    from .multihost import layout_grid
    from .partition import SlabPartition

    if np.ndim(shards) == 0:
        n = int(shards)
        part = SlabPartition(mesh, n)
        grid = layout_grid((n, 1, 1), devices, device=device)
        axes_spec = (("x", n) if n > 1 else None, None, None)
        lat_spec = ("x",)
    else:
        sh = _norm_shards(shards)
        part = GridPartition(mesh, sh)
        grid = layout_grid(sh, devices, device=device)
        axes_spec = tuple((AXES[a], sh[a]) if sh[a] > 1 else None
                          for a in range(3))
        lat_spec = AXES
    return part, grid, axes_spec, lat_spec


def make_fdm_apply_dist(mesh, Pdeg, part, axes_spec, lat_spec, kappa,
                        dtype, precision="highest", sigma=0.0, *, device,
                        grid=None):
    """FORWARD operator bundle ``A = (⊗ M V) diag(d) (⊗ V^T M)`` (``V^T M V
    = I``): the solve's pencil transposes with mass-weighted eigenvector
    matrices and the eigenvalue sums themselves. Returns ``(data, spec,
    apply)``; ``apply(fd, x)`` IS `fdm_solve_dist` on this data (the
    embedded zero rows give the operator's masked input and identity rows
    through the same epilogue). The sharded leapfrog's apply."""
    data, apply_fn = _bundle(mesh, Pdeg, part, axes_spec, kappa, dtype,
                             precision, sigma, device, forward=True,
                             grid=grid)
    return data, _spec(lat_spec), apply_fn


class DistFDM:
    """Whole-problem distributed direct solver (constant scalar, per-axis
    or diagonal-tensor kappa on an axis-aligned box; graded spacing, mixed
    Dirichlet / Neumann faces and Robin ends), every shard stacked on one
    device (``device``, CUDA unless the caller asks for the CPU).

    The sharded counterpart of `solvers.fdm.FastDiagonalizationSolver`:
    ``shards`` is an int (x-slab layout) or a 3-tuple (device grid); a
    solve is six per-axis contractions with pencil transposes on the
    sharded axes. With a process group up the shards span the ranks
    (``devices``: `multihost.rank_layout`), each rank building the whole
    stack on the host and uploading its block. Vectors in and out of
    `solve` are global flat vectors (numpy or tensors in, a tensor on
    ``device`` out, on every rank)."""

    def __init__(self, mesh, Pdeg, shards, kappa=2.0, dtype=torch.float32,
                 precision="highest", sigma=0.0, devices=None, *,
                 device="cuda"):
        self.mesh = mesh
        self.P = int(Pdeg)
        self.dtype = dtype
        self.device = torch.device(device)
        self.part, self.grid, axes_spec, lat_spec = dist_layout(
            mesh, shards, devices=devices, device=self.device)
        data, self._spec, solve = make_fdm_dist(
            mesh, self.P, self.part, axes_spec, lat_spec, kappa, dtype,
            precision=precision, sigma=sigma,
            device=self.grid.build_device(self.device), grid=self.grid)
        self.data = self.grid.place(data, self._spec, self.device)
        self._lat_spec = lat_spec
        self._axes_spec = tuple(axes_spec)
        self._solve_local = solve   # the hook (fd, b) on the stacked layout

    def to_dist(self, u):
        """A global flat vector -> the stacked layout (this rank's block)
        on the device, in the working dtype."""
        return self.grid.put_local(
            torch.as_tensor(u).reshape(self.mesh.lattice_shape(self.P)),
            self.part.local_shape(self.P), device=self.device,
            dtype=self.dtype)

    def from_dist(self, ud):
        """The stacked layout -> the global flat vector (a tensor)."""
        return self.grid.all_gather(ud).reshape(-1)

    def solve(self, b):
        """Global rhs in, global solution out (exact, one application)."""
        return self.from_dist(self._solve_local(self.data, self.to_dist(b)))
