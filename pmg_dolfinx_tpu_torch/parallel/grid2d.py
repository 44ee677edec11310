"""2D/3D device-grid decomposition, every shard stacked on one device (or,
across processes, each rank's block of shards on its device).

Port of `pmg_dolfinx_tpu.parallel.grid2d`. The lattice is split into
``(sx, sy, sz)`` boxes (any factor may be 1) with the interface planes
duplicated along every sharded axis; ownership weights (the product of
per-axis masks) count each dof once in a reduction. Every operator
backend leaves partial sums only on the duplicated interface planes, and
every cell lands on exactly one shard per axis, so one neighbour exchange
per sharded axis, taken in turn, reconciles edges and corners too, with no
diagonal communication.

Layout. JAX runs `GridPMG` as one ``shard_map`` program over a device
mesh. The port runs the same SPMD program with all shards stacked on one
device: a distributed vector is ONE tensor of shape ``(sx, sy, sz, nplx,
nply, nplz)``, shard-major, so each shard's block is contiguous and a
kernel takes it without a copy. Per-cell and quadrature-lattice arrays
are stacked the same way (`stack_blocks`). Pointwise work (axpy, the bc
``where``, the Chebyshev and FCG updates) runs on the whole tensor;
per-shard work (kernels 1 and 2 of ``kron_blocked``, K-A of
``lattice_blocked``, the per-shard einsums) runs on the blocks. The JAX
package's public duplicated layout ``(sx*nplx, sy*nply, sz*nplz)`` is
what `GridPartition.to_dist` gives; `stack_shards` / `unstack_shards`
convert between the two.

The seam. Every collective of the JAX program goes through one object,
`StackedGrid`: the non-wrapping ``ppermute`` of a plane along a grid axis,
the ``psum`` of a dot, and the ``all_gather`` / ``dynamic_slice`` of the
global coarse solve. On the stacked layout each is an exact tensor
operation on the three leading (shard) axes.

Backends: the Kronecker family (``kron``, ``kron_blocked``; scalar,
per-axis or diagonal-tensor kappa and a scalar sigma on axis-aligned
boxes with Dirichlet, Neumann or Robin faces and graded spacing, the
Robin ends and the grading folded into the 1D factors, per-shard
row-stacked on a sharded axis where the shards differ, so every shard's
kernel operands are its own) and the general family (``lattice``,
``lattice_blocked``, ``dofmap``; curved hexes, DG-0, per-axis and tensor
kappa, sigma fields, Robin faces and graded spacing, the shift and the
Robin boundary mass baked into one pointwise ``m3``). Smoothers: point
Jacobi, line relaxation along an unsharded axis (the global block
inverses laid out like the vectors, `stacked_line_blocks`) and the
cell-wise Schwarz blocks (per-shard dense axis transforms,
`stacked_schwarz`, the overlap-add reconciled by the grid exchange).
Coarse solves: ``cg``, ``smoother``, the gathered ``fdm``, ``direct``
and ``hmg``, and the non-gathered
``coarse_cfg["dist"]`` forms: ``fdm`` through `fdm_dist`'s pencil
transposes (`StackedGrid.all_to_all`) and ``hmg`` through
`build_hmg_grid` (boxes) or `build_hmg_grid_general` (the general
family), every h-level in the stacked layout. `GridPMG.solve_refined`
runs on every backend.

Across processes. With a process group up (`multihost.initialize`)
``devices=None`` spans every rank and an explicit ``devices=`` names the
rank of each shard (`multihost.rank_layout`): each rank holds a box of
shards, the seam is its `multihost.RankGrid` and the stacked program is
unchanged, every caller reading the local shard counts from
``grid.block``. The set-up arrays are built for the whole stack on the
host and each rank uploads its block (`GridPMG._place`, by
`grid_level_spec` or the builders' specs).

As in JAX, a per-cell or off-diagonal tensor kappa on the Kronecker
family raises ValueError. ``precision="high"`` runs the bf16x3 kernels
(#1/#9 and K-A on each shard) as `PMGHierarchy` does, with the transfers
at 'highest'. The 1D slab
(`parallel.dist.DistPMG`) goes through the same seam with ``shards=(S, 1,
1)``.
"""

import numpy as np
import torch

from ..ops.blas import dist_inner_product
from ..ops.kron_blocked import _check_precision
from ..solvers.cg import cg_solve
from ..solvers.pmg import (
    DEFAULT_CALIBRATION_ITERS,
    DEFAULT_CALIBRATION_RTOL,
    DEFAULT_SMOOTHER_ITERS,
    EIG_RANGE_FACTORS,
    Level,
    _level_precond,
    _merge_state,
    fmg_initial_guess,
    v_cycle,
)
from ..solvers.tridiag import lanczos_eigenvalue_estimates
from .partition import duplicate_planes

AXES = ("x", "y", "z")


def _norm_shards(shards):
    s = tuple(int(v) for v in shards)
    return s + (1,) * (3 - len(s))


class GridPartition:
    """Static multi-axis box partition with duplicated interface planes
    (host numpy, the JAX package's public layout)."""

    def __init__(self, mesh, shards=(2, 2)):
        self.mesh = mesh
        self.shards = _norm_shards(shards)
        for a, (nc_a, s_a) in enumerate(zip(mesh.nc, self.shards)):
            if nc_a % s_a:
                raise ValueError(f"nc[{a}]={nc_a} must divide shards {self.shards}")
        self.cells_per_shard = tuple(
            nc_a // s_a for nc_a, s_a in zip(mesh.nc, self.shards)
        )

    def local_shape(self, Pdeg):
        return tuple(c * Pdeg + 1 for c in self.cells_per_shard)

    def local_ndofs(self, Pdeg):
        a, b, c = self.local_shape(Pdeg)
        return a * b * c

    def _axis_starts(self, Pdeg, a):
        npl = self.cells_per_shard[a] * Pdeg + 1
        return [s * (npl - 1) for s in range(self.shards[a])], npl

    def to_dist(self, Pdeg, u):
        """Global flat vector -> duplicated layout ``(sx*nplx, sy*nply,
        sz*nplz)``."""
        lat = np.asarray(u).reshape(self.mesh.lattice_shape(Pdeg))
        for a in range(3):
            starts, npl = self._axis_starts(Pdeg, a)
            lat = np.concatenate(
                [np.take(lat, range(x0, x0 + npl), axis=a) for x0 in starts],
                axis=a,
            )
        return lat

    def from_dist(self, Pdeg, ud):
        """Duplicated layout -> global flat vector."""
        NX, NY, NZ = self.mesh.lattice_shape(Pdeg)
        sx, sy, sz = self.shards
        nplx, nply, nplz = self.local_shape(Pdeg)
        ud = np.asarray(ud).reshape(sx, nplx, sy, nply, sz, nplz)
        out = np.zeros((NX, NY, NZ), dtype=ud.dtype)
        xs, _ = self._axis_starts(Pdeg, 0)
        ys, _ = self._axis_starts(Pdeg, 1)
        zs, _ = self._axis_starts(Pdeg, 2)
        for i, x0 in enumerate(xs):
            for j, y0 in enumerate(ys):
                for k, z0 in enumerate(zs):
                    out[x0:x0 + nplx, y0:y0 + nply, z0:z0 + nplz] = ud[i, :, j, :, k]
        return out.reshape(-1)

    def ownership_weights(self, Pdeg):
        """Product of per-axis ownership masks (counts every dof once)."""
        ws = []
        for a in range(3):
            npl = self.cells_per_shard[a] * Pdeg + 1
            w = np.ones((self.shards[a], npl))
            w[:-1, -1] = 0.0
            ws.append(w.reshape(-1))
        return np.einsum("a,b,c->abc", *ws)


def stack_blocks(a, shards):
    """An array over the global grid, ``(X, Y, Z, *tail)`` (a tensor), cut
    into the ``shards`` boxes and stacked: ``(sx, sy, sz, X/sx, Y/sy,
    Z/sz, *tail)``, contiguous. On JAX's duplicated lattice layout it is
    `stack_shards`; on a per-cell ``(ncx, ncy, ncz, ...)`` or a
    quadrature-lattice ``(Qx, Qy, Qz, 6)`` array it gives each shard its
    own cells (quadrature points are cell-local, so the cut is exact)."""
    sx, sy, sz = shards
    X, Y, Z = a.shape[:3]
    tail = tuple(a.shape[3:])
    return (a.reshape((sx, X // sx, sy, Y // sy, sz, Z // sz) + tail)
            .permute((0, 2, 4, 1, 3, 5) + tuple(range(6, 6 + len(tail))))
            .contiguous())


def stack_shards(dup, shards):
    """JAX's duplicated layout ``(sx*nplx, sy*nply, sz*nplz)`` (a tensor)
    -> the stacked ``(sx, sy, sz, nplx, nply, nplz)`` layout, contiguous."""
    return stack_blocks(dup, shards)


def stack_gfirst(Gq, shards):
    """The quadrature-lattice geometry ``(Qx, Qy, Qz, 6)`` (a tensor) as
    each shard's own K-A operand, stacked: ``(sx, sy, sz, 6, Qxl, Qyl,
    Qzl)``, every shard's block contiguous (the kernel reads it through a
    raw pointer)."""
    return stack_blocks(Gq, shards).movedim(-1, 3).contiguous()


def unstack_shards(st):
    """The stacked layout -> JAX's duplicated layout."""
    sx, sy, sz, nx, ny, nz = st.shape
    return st.permute(0, 3, 1, 4, 2, 5).reshape(sx * nx, sy * ny, sz * nz)


class StackedGrid:
    """The collectives of the device-grid program on the stacked layout.

    All shards of the ``(sx, sy, sz)`` grid live in one tensor on one
    device, so each collective of the JAX package's ``shard_map`` program
    is an exact tensor operation on the three leading (shard) axes:
    `ppermute_planes` (the non-wrapping neighbour ``ppermute``), `dot`
    (the ``psum`` of an ownership-weighted dot), `psum` (the ``psum`` of a
    per-shard buffer: `dss_dist`'s shared-entity exchange and its
    ``direct`` coarse gather), `all_gather` (the global lattice,
    duplicated planes stripped), `local_slices` (each shard's
    ``dynamic_slice`` of a global lattice at its ``axis_index``) and
    `all_to_all` (the pencil transpose of `fdm_dist`).

    This object is the port's one seam for communication. Its ``block``
    (the leading shape of the tensors it takes) is the whole grid and its
    ``origin`` the first shard; the multi-process backend,
    `multihost.RankGrid`, holds one rank's box of shards and adds the
    cross-rank half of each method (a neighbour send/receive, an
    ``all_reduce``, an ``all_gather``, an ``all_to_all_single``). Every
    caller reads the local leading shape from ``block``, and places its
    set-up arrays and input vectors through `build_device`, `place` and
    `put_local`, which decide where the whole stack is built and cut.
    """

    def __init__(self, shards):
        self.shards = self.block = _norm_shards(shards)
        self.origin = (0, 0, 0)

    def build_device(self, device):
        """Where a solver on ``device`` builds its whole-stack set-up
        arrays: ``device`` itself, since every shard lives there."""
        return torch.device(device)

    def place(self, tree, spec, device):
        """Set-up arrays built for the whole stack on `build_device` ->
        this grid's shards on ``device``: here the same arrays. ``spec``
        (their layout tree, `multihost.take_block`'s) is what a rank's
        grid cuts its block by."""
        return tree

    def put_local(self, lat, local_shape, *, device, dtype):
        """A global lattice (numpy or a tensor) -> `local_slices` on
        ``device`` in ``dtype``: uploaded whole, then cut there."""
        lat = torch.as_tensor(lat).to(device=device, dtype=dtype)
        return self.local_slices(lat, local_shape)

    def ppermute_planes(self, first, last, axis):
        """Non-wrapping ``ppermute`` along grid axis ``axis`` of per-shard
        planes (leading dims the shard axes): returns ``(from_left,
        from_right)`` with ``from_left[s] = last[s - 1]`` and
        ``from_right[s] = first[s + 1]``, zeros at the chain ends. Both
        are new tensors: the planes are read before anyone adds them."""
        S = self.block[axis]
        from_left = torch.zeros_like(last)
        from_right = torch.zeros_like(first)
        if S > 1:
            cut = lambda a, b: (slice(None),) * axis + (slice(a, b),)
            from_left[cut(1, None)] = last[cut(None, S - 1)]
            from_right[cut(None, S - 1)] = first[cut(1, None)]
        return from_left, from_right

    def dot(self, u, v, weights):
        """``psum`` of the ownership-weighted local dots: a 0-d tensor."""
        return dist_inner_product(u, v, weights, AXES)

    def psum(self, buf):
        """JAX's ``psum`` over the shard axes of a per-shard buffer ``buf``
        (leading dims the shard axes): the total every shard sees, one
        reduction over the shard axes in a fixed order (the same sums on
        every call)."""
        return buf.sum(dim=(0, 1, 2))

    def all_gather(self, st):
        """The global lattice from the stacked one: per sharded axis the
        shards' blocks concatenated, the duplicated interface plane kept
        once (what every shard sees after JAX's ``all_gather``)."""
        lat = st.permute(0, 3, 1, 4, 2, 5)          # (sx, nx, sy, ny, sz, nz)
        for d in range(3):                          # merge dims (d, d + 1)
            S, n = lat.shape[d], lat.shape[d + 1]
            rest = tuple(lat.shape[d + 2:])
            head = lat.narrow(d + 1, 0, n - 1).reshape(
                tuple(lat.shape[:d]) + (S * (n - 1),) + rest)
            tail = lat.select(d, S - 1).narrow(d, n - 1, 1)
            lat = torch.cat([head, tail], dim=d)
        return lat

    def local_slices(self, lat, local_shape):
        """Each shard's block of a global lattice (JAX's ``dynamic_slice``
        at ``axis_index * (npl - 1)`` per sharded axis), stacked: the
        shards of ``block`` from ``origin``."""
        nx, ny, nz = local_shape
        lat = lat[tuple(slice(o * (n - 1), (o + b) * (n - 1) + 1)
                        for o, b, n in zip(self.origin, self.block,
                                           local_shape))]
        blocks = (lat.unfold(0, nx, nx - 1).unfold(1, ny, ny - 1)
                  .unfold(2, nz, nz - 1))
        return blocks.contiguous()

    def all_to_all(self, st, axis, split_axis, concat_axis):
        """JAX's tiled ``all_to_all(x, axis_name, split_axis, concat_axis,
        tiled=True)`` over grid axis ``axis`` on the stacked ``st``: every
        shard cuts its local ``split_axis`` (0-2, a multiple of the shard
        count ``S`` long) into ``S`` chunks and sends chunk ``j`` to shard
        ``j`` of its row along ``axis``, which concatenates what it
        receives along its local ``concat_axis`` in sender order. Swapping
        the two axes undoes it. Here it is one exact permute-and-reshape
        copy of the shard axes (`multihost.RankGrid` adds one
        ``all_to_all_single`` over the ranks of that row). Returns a new
        contiguous tensor."""
        S = self.shards[axis]
        if S == 1:
            return st
        if split_axis == concat_axis:
            raise ValueError("all_to_all: split_axis and concat_axis must "
                             "differ")
        x = st.movedim(axis, 0)       # (S, o1, o2, n0, n1, n2)
        L = x.shape[3 + split_axis]
        if L % S:
            raise ValueError(f"all_to_all: local axis {split_axis} of length "
                             f"{L} does not split into {S} chunks")
        x = x.unflatten(3 + split_axis, (S, L // S))
        names = ["s", "o1", "o2"]
        target = ["j", "o1", "o2"]
        out = list(x.shape[:3])
        out[0] = S
        for k in range(3):
            if k == split_axis:
                names += ["j", "in"]
                target += ["in"]
                out.append(L // S)
            else:
                names.append(f"n{k}")
                target += (["s", f"n{k}"] if k == concat_axis
                           else [f"n{k}"])
                n = st.shape[3 + k]
                out.append(S * n if k == concat_axis else n)
        y = x.permute([names.index(n) for n in target]).reshape(out)
        return y.movedim(0, axis).contiguous()


def _exchange_axis(lat, grid, dim, inplace=False):
    """Partial-sum reconciliation of the duplicated planes of lattice dim
    ``dim`` (0, 1, 2) across grid axis ``dim`` on the stacked ``lat``: each
    shard adds its neighbours' interface planes to its own first and last
    plane. Returns a new tensor, or writes ``lat`` when ``inplace``."""
    if grid.shards[dim] == 1:
        return lat
    d = 3 + dim
    n = lat.shape[d]
    from_left, from_right = grid.ppermute_planes(
        lat.select(d, 0), lat.select(d, n - 1), dim)
    out = lat if inplace else lat.clone()
    out.select(d, 0).add_(from_left)
    out.select(d, n - 1).add_(from_right)
    return out


def _plane_exchange_pair(grid, axis):
    """Neighbour exchange of interface-plane PARTIALS along grid axis
    ``axis``: ``ex(first, last) -> (add to my first plane, add to my last
    plane)``, zeros at the chain ends."""

    def ex(first, last):
        return grid.ppermute_planes(first, last, axis)

    return ex


def _stacked_contract(M, t, dim):
    """``M`` contracted with the local axis ``dim`` of every shard of the
    stacked ``t``: one matrix for all shards, or ``(S_dim, n_out, n_in)``
    per-shard blocks along grid axis ``dim`` (a sharded graded axis)."""
    if M.dim() == 3:
        eq = ("iax,ijkxyz->ijkayz", "jby,ijkxyz->ijkxbz",
              "kcz,ijkxyz->ijkxyc")
    else:
        eq = ("ax,...xyz->...ayz", "by,...xyz->...xbz", "cz,...xyz->...xyc")
    return torch.einsum(eq[dim], M, t)


def _grid_of(shards):
    """The layout a factory's ``shards`` slot names: JAX's shard counts
    (every shard stacked here, `StackedGrid`) or the solver's own grid (a
    `StackedGrid` or a rank's `multihost.RankGrid`), whose ``block`` is
    the leading shape of the tensors it takes."""
    return shards if isinstance(shards, StackedGrid) else StackedGrid(shards)


def _grid_common_ops(shards, precision):
    """The backend-independent V-cycle primitives on the box partition:
    transfers (ownership-weighted restriction with one exchange per
    sharded axis; prolongation needs none) and the ownership-weighted
    dot."""
    from ..ops.kron_blocked import _check_precision

    _check_precision(precision)
    grid = _grid_of(shards)

    def restrict_op(tr, r, level_c, level_f):
        lat = r * tr["weights_f"]
        for dim, name in enumerate(("Ix", "Iy", "Iz")):
            lat = _stacked_contract(tr[name].mT, lat, dim)
        for a in range(3):
            lat = _exchange_axis(lat, grid, a, inplace=True)
        return lat.contiguous()

    def prolong_op(tr, u, level_c, level_f):
        lat = u
        for dim, name in enumerate(("Ix", "Iy", "Iz")):
            lat = _stacked_contract(tr[name], lat, dim)
        return lat.contiguous()

    def exchange(lat):
        for a in range(3):
            lat = _exchange_axis(lat, grid, a)
        return lat

    return dict(
        restrict=restrict_op, prolong=prolong_op,
        dot=lambda u, v, lv: grid.dot(u, v, lv["weights"]),
        zeros=lambda level, like: torch.zeros(
            grid.block + tuple(level.shape), dtype=like.dtype,
            device=like.device),
        exchange=exchange,
    )


def _local_axis_factors(K, m, S, n):
    """Per-shard ``Kt_a = K_a / (s s^T)`` ``(S, n, n)`` and ``s = sqrt(m)``
    ``(S, n)`` from a local ``K`` (one ``(n, n)`` or row-stacked ``(S*n,
    n)``) and the duplicated-layout mass ``m``."""
    s = torch.sqrt(m).reshape(S, n)
    K = K.reshape(-1, n, n)
    return K / s[:, :, None] / s[:, None, :], s


def grid_kron_cycle_ops(shards, precision="highest", sigma=0.0):
    """V-cycle primitives on the box partition, plain torch Kronecker-sum
    apply: the symmetrized form ``A = S (Kt_x ⊕ Kt_y ⊕ Kt_z) S`` per
    shard (batched over the shard axes), each term reconciled by one
    exchange along its own axis; stacked lattice vectors throughout.
    ``shards`` may be the solver's grid (`_grid_of`); the local shard
    counts are its ``block``."""
    grid = _grid_of(shards)

    def apply_op(lv, x, level):
        (Sx, Sy, Sz), (nx, ny, nz) = grid.block, level.shape
        Ktx, sx = _local_axis_factors(lv["Kx"], lv["mx"], Sx, nx)
        Kty, sy = _local_axis_factors(lv["Ky"], lv["my"], Sy, ny)
        Ktz, sz = _local_axis_factors(lv["Kz"], lv["mz"], Sz, nz)
        s3 = (sx[:, None, None, :, None, None]
              * sy[None, :, None, None, :, None]
              * sz[None, None, :, None, None, :])
        w = torch.where(lv["bc_marker"], torch.zeros_like(x), x) * s3
        t1 = _exchange_axis(torch.einsum("iax,ijkxyz->ijkayz", Ktx, w),
                            grid, 0, inplace=True)
        t2 = _exchange_axis(torch.einsum("jby,ijkxyz->ijkxbz", Kty, w),
                            grid, 1, inplace=True)
        t3 = _exchange_axis(torch.einsum("kcz,ijkxyz->ijkxyc", Ktz, w),
                            grid, 2, inplace=True)
        t = t1 + t2 + t3
        if sigma:
            # sigma*w*s3 == sigma*M*mask(x): pointwise, consistent on the
            # duplicated planes, so no exchange is needed.
            t = t + sigma * w
        return torch.where(lv["bc_marker"], x, t * s3)

    return dict(_grid_common_ops(grid, precision), apply=apply_op)


def grid_kron_blocked_cycle_ops(shards, precision="highest", sigma=0.0):
    """Grid V-cycle primitives over the blocked kernel pair: kernel 1's
    output (the x term) rides the full-plane exchange between the two
    kernels; the y/z edge partials are computed from x, exchanged per
    axis, and the received planes feed kernel 2 (#9, or #8 on a
    non-separable marker) as correction inputs
    (`ops.kron_blocked.blocked_kron_apply_grid`, on the level's per-shard
    ``kb_blocks`` where it has them). The down-sweep residual is fused into
    kernel 2. Transfers and dots are `_grid_common_ops`."""
    from ..ops.kron_blocked import blocked_kron_apply_grid

    grid = _grid_of(shards)
    shards = grid.shards
    # kernel 1's output is the entry point's own tensor: reconcile in place
    ex_x = ((lambda t1: _exchange_axis(t1, grid, 0, inplace=True))
            if shards[0] > 1 else None)
    ex_y = _plane_exchange_pair(grid, 1) if shards[1] > 1 else None
    ex_z = _plane_exchange_pair(grid, 2) if shards[2] > 1 else None

    def apply_op(lv, x, level):
        return blocked_kron_apply_grid(
            x, lv["bc_marker"], lv["kb_mats"], precision=precision,
            exchange_x=ex_x, ex_y=ex_y, ex_z=ex_z, sigma=sigma,
            blocks=lv.get("kb_blocks"),
        )

    def residual_op(lv, b, u, level):
        return blocked_kron_apply_grid(
            u, lv["bc_marker"], lv["kb_mats"], precision=precision,
            exchange_x=ex_x, ex_y=ex_y, ex_z=ex_z, sigma=sigma, r3=b,
            blocks=lv.get("kb_blocks"),
        )

    return dict(_grid_common_ops(grid, "highest"), apply=apply_op,
                residual=residual_op)


_LATTICE_MATS = ("Ex", "Dx", "Ey", "Dy", "Ez", "Dz")


def _general_apply(raw, shards, sigma):
    """``apply(lv, x, level)`` of a general backend from its per-shard raw
    apply (Dirichlet dofs zeroed on input, no bc rows): the partial sums on
    the duplicated interface planes reconciled by one exchange per sharded
    axis in turn (a general G couples the axes at a quadrature point, but
    each cell lands on one shard per axis, so after the x exchange both
    x-copies agree, the y exchange adds neighbours already x-summed, and so
    on), then the pointwise shift ``sigma * m3 * x`` (``m3`` bc-zeroed,
    a sigma field and the Robin boundary mass baked in) and the Dirichlet
    rows."""
    grid = _grid_of(shards)

    def apply_op(lv, x, level):
        y = raw(lv, x, level)
        for a in range(3):
            y = _exchange_axis(y, grid, a, inplace=True)
        if sigma:
            y = y + sigma * lv["m3"] * x
        return torch.where(lv["bc_marker"], x, y)

    return apply_op


def grid_lattice_cycle_ops(shards, precision="highest", sigma=0.0):
    """V-cycle primitives of the plain-torch lattice backend on the box
    partition (general hexes, DG-0 or tensor kappa folded into G): the
    lattice apply of every shard (batched over the shard axes, each shard's
    own quadrature-lattice geometry ``G`` ``(sx, sy, sz, Qxl, Qyl, Qzl,
    6)`` and the LOCAL axis matrices) with ``apply_bc=False``, then
    `_general_apply`'s exchanges, shift and bc rows; `_grid_common_ops`
    transfers."""
    from ..ops.kron_blocked import _check_precision
    from ..ops.lattice import lattice_laplacian_apply

    _check_precision(precision)
    grid = _grid_of(shards)

    def raw(lv, x, level):
        return lattice_laplacian_apply(
            x, {k: lv[k] for k in _LATTICE_MATS}, lv["G"], lv["bc_marker"],
            apply_bc=False)

    return dict(_grid_common_ops(grid, precision),
                apply=_general_apply(raw, grid, sigma))


def grid_lattice_blocked_cycle_ops(shards, precision="highest", sigma=0.0):
    """The grid lattice backend over K-A (`ops.lattice_blocked.
    blocked_lattice_apply` with ``apply_bc=False``), one launch per shard
    on its contiguous block of the stacked vector, marker and ``Gt``
    ``(sx, sy, sz, 6, Qxl, Qyl, Qzl)``; a CPU tensor runs the plain
    version per shard. The exchanges, shift and bc rows as
    `grid_lattice_cycle_ops`."""
    from ..ops.lattice_blocked import blocked_lattice_apply

    grid = _grid_of(shards)
    block = grid.block
    idx = [(i, j, k) for i in range(block[0]) for j in range(block[1])
           for k in range(block[2])]

    def raw(lv, x, level):
        nc = tuple((N - 1) // level.P for N in level.shape)
        x = x.contiguous()
        y = torch.stack([blocked_lattice_apply(
            x[s], lv["lb_mats"], lv["Gt"][s], lv["bc_marker"][s], nc,
            level.P, precision=precision, apply_bc=False) for s in idx])
        return y.reshape(x.shape)

    return dict(_grid_common_ops(grid, precision),
                apply=_general_apply(raw, grid, sigma))


def grid_dofmap_cycle_ops(shards, sigma=0.0):
    """Grid V-cycle primitives over the dofmap oracle (gather -> per-cell
    sum-factorised apply -> scatter-add, `ops.laplacian`): the per-cell
    arrays are stacked per shard (``G`` ``(sx, sy, sz, ncl, nq, 6)``,
    ``coeff`` ``(sx, sy, sz, ncl)``, cells in the local box order) and the
    scatter targets each shard's LOCAL box dofmap, offset per shard into the
    stacked vector; every cell's contributions land inside its shard's
    duplicated-plane lattice, so the same exchanges reconcile them."""
    from ..ops.laplacian import laplacian_scatter_raw
    from .dist import _stacked_dofmap

    grid = _grid_of(shards)
    S = grid.block[0] * grid.block[1] * grid.block[2]

    def raw(lv, x, level):
        G = lv["G"]
        y = laplacian_scatter_raw(
            x.reshape(-1), _stacked_dofmap(lv["dofmap"], S, level.ndofs),
            G.reshape((-1,) + tuple(G.shape[-2:])), lv["coeff"].reshape(-1),
            lv["D"], lv["bc_marker"].reshape(-1))
        return y.reshape(x.shape)

    return dict(_grid_common_ops(grid, "highest"),
                apply=_general_apply(raw, grid, sigma))


def grid_coarse_hooks(part, P0, *, grid=None):
    """Gather/slice hooks of the global coarse solve on the box partition:
    ``coarse_gather`` takes the stacked coarse vector to the global
    lattice (the duplicated interface planes stripped), ``coarse_slice``
    a global lattice (or flat vector) back to the stacked layout (this
    rank's block on a `multihost.RankGrid`)."""
    grid = _grid_of(part.shards if grid is None else grid)
    npls = part.local_shape(P0)
    glob = part.mesh.lattice_shape(P0)

    def coarse_gather(b0_local):
        return grid.all_gather(b0_local)

    def coarse_slice(ug):
        return grid.local_slices(ug.reshape(glob), npls)

    return coarse_gather, coarse_slice


def _host(a):
    """A tensor's host numpy copy; numpy passes through."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


def stacked_line_blocks(blocks, part, Pdeg, axis, dtype, device):
    """Global line-block inverses ``blocks`` (numpy or a tensor) in the
    stacked layout: ``(sx, sy, sz, npl_a, npl_b, n, n)`` over the two
    non-line axes ``a < b`` (the line axis's shard dim is 1), duplicated
    lines holding identical blocks; `line_precond_apply` reads them in the
    order of the stacked vector with the line axis moved last."""
    from ..solvers.line import shard_line_blocks

    others = [a for a in range(3) if a != axis]
    dup = shard_line_blocks(
        _host(blocks), part.mesh.lattice_shape(Pdeg), axis,
        [part._axis_starts(Pdeg, a) for a in others])
    (s0, s1), (n0, n1) = ((part.shards[a] for a in others),
                          (part.local_shape(Pdeg)[a] for a in others))
    n = dup.shape[-1]
    st = (torch.as_tensor(dup, dtype=dtype, device=device)
          .reshape(s0, n0, s1, n1, n, n).permute(0, 2, 1, 3, 4, 5))
    return st.unsqueeze(axis).contiguous()


def stacked_schwarz(swg, part, Pdeg, dtype, device):
    """The global Schwarz data ``swg`` (`build_schwarz_np`'s arrays, numpy
    or tensors) in the stacked layout: each dense axis transform as
    per-shard blocks ``(S_a, ncl_a*n, npl_a)`` (`shard_dense_axis`),
    ``ginv`` cut cell-contiguously per shard and the marker in the
    duplicated-plane layout."""
    from ..solvers.schwarz import shard_dense_axis

    sw = {k: torch.as_tensor(
        shard_dense_axis(_host(swg[k]), Pdeg, *part._axis_starts(Pdeg, a)),
        dtype=dtype, device=device).reshape(part.shards[a], -1,
                                            part.local_shape(Pdeg)[a])
        for a, k in enumerate(("Ux", "Uy", "Uz"))}
    sw["ginv"] = stack_shards(torch.as_tensor(
        _host(swg["ginv"]), dtype=dtype, device=device), part.shards)
    sw["bc"] = stack_shards(torch.as_tensor(part.to_dist(
        Pdeg, np.asarray(_host(swg["bc"]), np.float64)) > 0.5,
        device=device), part.shards)
    return sw


def _hmg_grid_scaffold(mesh, shards, P0, dtype, smoother_iters,
                       min_cells, divisors, global_build, make_mesh,
                       fill_level, sizes=None, line_axis=None,
                       bottom_fdm=None, *, device):
    """The frame of `build_hmg_grid` / `build_hmg_grid_general`: divisors
    validation, shard-aligned level sizes, the global calibration pass
    (``global_build(sizes) -> (g_data, g_bottom)``), each level's base data
    (marker, diagonal, weights, lmax, line blocks or Schwarz data) in the
    stacked layout, the per-axis h-transfers (per-shard blocks on a sharded
    graded axis) and the bottom-solve hooks. The backend's
    operator arrays come from ``fill_level(lv, spec, m, p_l, g_lv)``.
    ``bottom_fdm`` (kwargs of `make_fdm_dist`) makes the bottom the
    distributed FDM, so the hierarchy never gathers. The arrays are the
    whole stack on ``device``; when ``shards`` is a rank's grid
    (`_grid_of`) the bottom-solve hooks communicate through it, and the
    caller cuts the rank's block from the arrays by ``specs``."""
    from ..solvers.hmg import local_axis_h_interpolation
    from .dist import _hmg_sizes

    grid = _grid_of(shards)
    shards = grid.shards
    # The hierarchy's DEPTH depends on the alignment constraint:
    # ``divisors`` (coarse_cfg['divisors']) pins one constraint across
    # layouts (the largest of a scaling sweep), so trajectories stay
    # layout-invariant.
    div = _norm_shards(divisors) if divisors is not None else shards
    for a, (d, s_a) in enumerate(zip(div, shards)):
        if d % s_a:
            raise ValueError(
                f"divisors[{a}]={d} must be a multiple of shards[{a}]={s_a} "
                "(levels divisible by the override stay shard-aligned)"
            )
    sizes = _hmg_sizes(mesh.nc, div, sizes, min_cells,
                       f"the shard grid (divisors={div})")
    if len(sizes) < 2:
        raise ValueError(
            f"mesh nc={mesh.nc} is not h-coarsenable with cells "
            f"divisible by shards={shards} (divisors={div}); use the "
            "gathered hmg coarse (coarse_cfg without dist=True) or a "
            "shard-friendlier mesh"
        )
    if line_axis is not None and shards[line_axis] != 1:
        raise ValueError(
            f"distributed (dist=True) h-MG line smoother along "
            f"{'xyz'[line_axis]} needs shards[{line_axis}]==1 (lines "
            f"must not span shards); got shards={shards}"
        )
    meshes = [make_mesh(nc) for nc in sizes[::-1]]
    g_data, g_bottom = global_build(sizes)
    parts = [GridPartition(m, shards) for m in meshes]
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    st = lambda dup: stack_shards(t(dup), shards)

    levels, level_data, level_specs = [], [], []
    for m, p_l, g_lv in zip(meshes, parts, g_data["levels"]):
        lv = dict(
            bc_marker=stack_shards(torch.as_tensor(p_l.to_dist(
                P0, m.boundary_dof_marker(P0)) > 0.5, device=device),
                shards),
            diag_inv=st(p_l.to_dist(P0, _host(g_lv["diag_inv"]).reshape(-1))),
            weights=st(p_l.ownership_weights(P0)),
            lmax=g_lv["lmax"],
        )
        spec = dict(bc_marker=AXES, diag_inv=AXES, weights=AXES, lmax=())
        if line_axis is not None:
            lv["line_inv"] = stacked_line_blocks(g_lv["line_inv"], p_l, P0,
                                                 line_axis, dtype, device)
            spec["line_inv"] = AXES
        if "schwarz" in g_lv:
            lv["schwarz"] = stacked_schwarz(g_lv["schwarz"], p_l, P0, dtype,
                                            device)
            spec["schwarz"] = dict(Ux=("x",), Uy=("y",), Uz=("z",),
                                   ginv=AXES, bc=AXES)
        fill_level(lv, spec, m, p_l, g_lv)
        levels.append(Level(P=P0, ndofs=p_l.local_ndofs(P0),
                            smoother_iters=smoother_iters,
                            shape=p_l.local_shape(P0),
                            line_axis=(line_axis if line_axis is not None
                                       else 2)))
        level_data.append(lv)
        level_specs.append(spec)

    transfer, transfer_specs = [], []
    for (mc, pc), (mf, pf) in zip(zip(meshes, parts),
                                  zip(meshes[1:], parts[1:])):
        tr, tspec = {}, dict(weights_f=AXES)
        for a, name in enumerate("xyz"):
            # A sharded GRADED axis gets per-shard blocks (S_a, Nf, Nc).
            I_a, stacked = local_axis_h_interpolation(
                pc.cells_per_shard[a], P0, mf.nc[a] // mc.nc[a], shards[a],
                h_fine=mf.h_cells[a] if mf.is_graded else None)
            tr["I" + name] = t(I_a)
            if stacked:
                tr["I" + name] = tr["I" + name].reshape(
                    shards[a], -1, I_a.shape[1])
            tspec["I" + name] = (AXES[a],) if stacked else ()
        tr["weights_f"] = st(pf.ownership_weights(P0))
        transfer.append(tr)
        transfer_specs.append(tspec)

    data = dict(levels=level_data, transfer=transfer)
    specs = dict(levels=level_specs, transfer=transfer_specs)
    if "coarse_chol" in g_data:
        data["coarse_chol"] = g_data["coarse_chol"]
        specs["coarse_chol"] = ()
    bottom_solve = None
    if bottom_fdm is not None:
        # The distributed-FDM bottom: an exact solve at the coarsest
        # h-level through per-axis pencil transposes, no gather anywhere.
        from .fdm_dist import make_fdm_dist

        data["fdm"], specs["fdm"], bottom_solve = make_fdm_dist(
            meshes[0], P0, parts[0],
            tuple((AXES[a], shards[a]) if shards[a] > 1 else None
                  for a in range(3)),
            AXES, dtype=dtype, device=device, grid=grid, **bottom_fdm)
        g_bottom = "fdm"
    hmg_gather, hmg_slice = grid_coarse_hooks(parts[0], P0, grid=grid)
    return (tuple(levels), data, specs, g_bottom, hmg_gather, hmg_slice,
            bottom_solve)


def build_hmg_grid(mesh, shards, P0, kappa, dtype, smoother_iters=2,
                   precision="highest", bottom="direct", min_cells=2,
                   sigma=0.0, divisors=None, sizes=None, smoother="cheb", *,
                   device):
    """Distributed (non-gathered) h-multigrid coarse hierarchy on the 2D/3D
    box partition, every shard stacked on ``device``: the multi-axis
    `parallel.dist.build_hmg_dist`.

    Coarsening is shard-aligned on every sharded axis (each level's cell
    counts divisible by ``shards``, or by ``divisors``), so each level
    keeps the stacked duplicated-plane layout: applies are
    `grid_kron_cycle_ops` (one exchange per sharded axis), transfers the
    local blocks of the per-axis h-interpolation (`_grid_common_ops`), and
    only the bottom solve may gather (``bottom="fdm"``: none does).
    Calibration, diagonals, line / Schwarz data and the bottom factor come
    from one global `build_hmg` pass over the same level sizes. Returns
    ``(levels, data, specs, bottom_mode, gather, unslice,
    bottom_solve)``, as `build_hmg_dist`."""
    from ..fem.assembly import resolve_kappa_axes
    from ..ops.kron import axis_stiffness_mass, local_axis_K
    from ..solvers.line import parse_line_smoother
    from .dist import _hmg_box_meshes, _hmg_global

    kax = resolve_kappa_axes(mesh, kappa)
    line_axis = (None if smoother == "schwarz" else parse_line_smoother(
        smoother, mesh, np.diag(kax),
        allowed=tuple(a for a, sh in enumerate(_grid_of(shards).shards)
                      if sh == 1)))

    def global_build(sizes):
        return _hmg_global(mesh, P0, kappa, dtype, smoother_iters,
                           precision, bottom, min_cells, sigma, sizes,
                           smoother, device)

    def fill_level(lv, spec, m, p_l, g_lv):
        # Local per-shard stiffness (interface partials reconciled by the
        # exchange), the global axis mass in the duplicated layout.
        npls = p_l.local_shape(P0)
        for a, name in enumerate("xyz"):
            # Robin ends rediscretise per h-level (row-stacked per shard
            # on a sharded axis where they or the grading differ).
            Kl, stacked = local_axis_K(m, a, p_l.cells_per_shard[a], P0,
                                       kax[a], p_l.shards[a])
            _, mg = axis_stiffness_mass(m.nc[a], P0, m.h_cells[a])
            lv["K" + name] = torch.as_tensor(Kl, dtype=dtype, device=device)
            lv["m" + name] = torch.as_tensor(
                duplicate_planes(mg, npls[a], p_l.shards[a]), dtype=dtype,
                device=device)
            spec["K" + name] = (AXES[a],) if stacked else ()
            spec["m" + name] = (AXES[a],)

    return _hmg_grid_scaffold(
        mesh, shards, P0, dtype, smoother_iters, min_cells, divisors,
        global_build,
        lambda nc: _hmg_box_meshes(mesh, [nc])[0],
        fill_level, sizes=sizes, line_axis=line_axis,
        bottom_fdm=(dict(kappa=kappa, precision=precision, sigma=sigma)
                    if bottom == "fdm" else None),
        device=device)




def build_hmg_grid_general(mesh, shards, P0, kappa, dtype,
                           smoother_iters=2, precision="highest",
                           bottom="direct", min_cells=2, sigma=0.0,
                           divisors=None, sizes=None, smoother="cheb",
                           sigma_field=None, *, device):
    """Distributed h-multigrid coarse hierarchy of the general family
    (curved hexes, DG-0 or tensor kappa, sigma fields, Robin faces, graded
    spacing) on the 2D/3D box partition, every shard stacked on
    ``device``: the lattice twin of `build_hmg_grid`, the curved operator
    rediscretised per h-level as `solvers.hmg.build_hmg_general` does.

    Every h-level keeps the stacked duplicated-plane layout: its
    quadrature-lattice geometry (kappa folded in) is cut per shard
    (`stack_blocks`; quadrature points are cell-local), applies are
    `grid_lattice_cycle_ops`, transfers the local per-axis h-interpolation
    blocks (per shard on a sharded graded axis), and only the coarsest
    bottom solve gathers. Calibration, diagonals, the per-level ``G`` and
    ``m3`` (the sigma field and each level's Robin mass baked in) and the
    bottom factor come from one global `build_hmg_general` pass over the
    same level sizes, whose arrays are reused, not recomputed. Returns
    ``(levels, data, specs, bottom_mode, gather, unslice, bottom_solve)``,
    as `build_hmg_grid` (``bottom_solve`` None: the bottom gathers)."""
    from ..fem.assembly import lumped_mass_np
    from ..fem.mesh import BoxMesh, PerturbedBoxMesh
    from ..ops.lattice import lattice_mats
    from ..solvers.hmg import _level_mesh, _same_or, build_hmg_general
    from ..solvers.line import parse_line_smoother

    grid = _grid_of(shards)
    shards = grid.shards
    line_axis = (None if smoother == "schwarz" else parse_line_smoother(
        smoother, mesh, kappa,
        allowed=tuple(a for a, sh in enumerate(shards) if sh == 1)))

    def global_build(sizes):
        _, g_data, g_bottom, _ = build_hmg_general(
            mesh, P0, kappa, dtype, smoother_iters=smoother_iters,
            precision=precision, bottom=bottom, min_cells=min_cells,
            sigma=sigma, sigma_field=sigma_field, sizes=sizes,
            smoother=smoother, device=device)
        return g_data, g_bottom

    if isinstance(mesh, PerturbedBoxMesh):
        make = _level_mesh(mesh, PerturbedBoxMesh, warp=mesh._warp)
    else:
        make = _level_mesh(mesh, BoxMesh)
    robin = bool(getattr(mesh, "has_robin", False))

    def fill_level(lv, spec, m, p_l, g_lv):
        lv["G"] = stack_blocks(g_lv["G"], shards)
        spec["G"] = AXES
        if sigma or robin:
            m3 = (_host(g_lv["m3"]) if "m3" in g_lv
                  else lumped_mass_np(m, P0, bc_zero=True))
            lv["m3"] = stack_shards(torch.as_tensor(
                p_l.to_dist(P0, m3), dtype=dtype, device=device), shards)
            spec["m3"] = AXES
        lv.update(lattice_mats(p_l.cells_per_shard, P0, dtype, device))
        spec.update({k: () for k in _LATTICE_MATS})

    return _hmg_grid_scaffold(
        mesh, grid, P0, dtype, smoother_iters, min_cells, divisors,
        global_build, lambda nc: _same_or(mesh, nc, make), fill_level,
        sizes=sizes, line_axis=line_axis, device=device)


def grid_level_spec(lv, shards):
    """The layout of each array of a `GridPMG` level (JAX's PartitionSpec
    tree, `multihost.take_block`'s ``spec``): the stacked lattices and
    per-cell / quadrature-lattice arrays over the three grid axes, the
    per-axis masses, row-stacked stiffness and Schwarz transforms over
    their own axis, ``kb_mats`` by rows and columns as
    `ops.kron_blocked.grid_symmetrized_mats` stacks them, the rest
    replicated."""
    from ..ops.kron_blocked import _GRID_AXES

    spec = {}
    for k, v in lv.items():
        if k in ("bc_marker", "weights", "diag_inv", "m3", "G", "Gt",
                 "coeff", "line_inv"):
            spec[k] = AXES
        elif k == "schwarz":
            spec[k] = dict(Ux=("x",), Uy=("y",), Uz=("z",), ginv=AXES,
                           bc=AXES)
        elif k in ("Kx", "Ky", "Kz", "mx", "my", "mz"):
            a = "xyz".index(k[1])
            stacked = k[0] == "m" or (shards[a] > 1 and v.shape[0]
                                      == shards[a] * v.shape[-1])
            spec[k] = (AXES[a],) if stacked else ()
        elif k == "kb_mats":
            spec[k] = {key: _GRID_AXES[key] for key in v if key != "band"}
    return spec


class GridPMG:
    """p-multigrid over a 2D/3D device grid, every shard stacked on one
    device (``device``, CUDA unless the caller asks for the CPU) or, with a
    process group up, each rank's box of shards on its ``device``
    (``devices=None``: row-major equal blocks over every rank; else the
    rank of each shard, row-major). `to_dist` gives the rank's block;
    `from_dist`, the solution and the residual lists are the same on
    every rank.

    The JAX package's signature. Operator backends: ``"kron"`` (plain
    torch, any float dtype) and ``"kron_blocked"`` (the CUDA kernels #1-#9,
    float32) on axis-aligned boxes (Robin faces and graded spacing
    included) with a scalar, per-axis or diagonal-tensor kappa;
    ``"lattice"`` (plain torch), ``"lattice_blocked"`` (K-A once per
    shard, float32) and
    ``"dofmap"`` on curved hexes with a scalar, per-axis, DG-0 (array or
    callable) or tensor kappa, a sigma field and Robin faces or graded
    spacing. Coarse solvers ``"cg"`` (default), ``"smoother"``, the
    gathered ``"fdm"``, ``"direct"`` and ``"hmg"``, and with
    ``coarse_cfg=dict(dist=True)`` the non-gathered ``"fdm"`` (pencil
    transposes) and ``"hmg"`` (`build_hmg_grid` on constant-kappa boxes,
    `build_hmg_grid_general` otherwise); smoothers ``"cheb"`` (point
    Jacobi), ``"line"`` / ``"line-x|y|z"`` (the line axis unsharded) and
    ``"schwarz"`` (any layout). Methods `solve`, `solve_pcg`,
    `solve_refined`, `to_dist`, `from_dist` and `load_state`; vectors in
    and out are global flat vectors (numpy or tensors in, tensors on
    ``device`` out).
    """

    def __init__(self, mesh, shards=(2, 2), degrees=(1, 3), kappa=2.0,
                 dtype=torch.float64, smoother_iters=DEFAULT_SMOOTHER_ITERS,
                 coarse="cg", coarse_cfg=None, devices=None,
                 calibration_iters=DEFAULT_CALIBRATION_ITERS,
                 operator="kron", precision="highest", sigma=0.0,
                 smoother="cheb", *, device="cuda"):
        from ..fem.assembly import (
            ops_shift_scalar,
            resolve_kappa_axes,
            resolve_kappa_split,
            resolve_sigma,
        )
        from ..fem.mesh import require_axis_aligned
        from ..solvers.line import parse_line_smoother

        from .multihost import layout_grid

        self.part = GridPartition(mesh, shards)
        shards = self.part.shards
        self.device = torch.device(device)
        # every shard stacked here, or this rank's block of them
        self.grid = layout_grid(shards, devices, device=self.device)
        self.sigma, self._sigma_field = resolve_sigma(sigma)
        if self._sigma_field is not None:
            if operator in ("kron", "kron_blocked"):
                raise ValueError(
                    "a sigma FIELD (callable) requires a general backend "
                    "— the Kronecker paths carry only a separable scalar "
                    "shift"
                )
            if coarse == "fdm":
                raise ValueError(
                    "a sigma FIELD supports cg/smoother/direct/hmg "
                    "coarse solvers only"
                )
            if smoother != "cheb" or (coarse_cfg or {}).get(
                    "smoother", "cheb") != "cheb":
                raise ValueError(
                    "line/schwarz smoothers support a scalar sigma only"
                )
        self._robin = bool(getattr(mesh, "has_robin", False))
        if (not any(any(f) for f in getattr(mesh, "dirichlet_faces",
                                            ((True, True),) * 3))
                and self.sigma == 0.0 and not self._robin):
            raise ValueError(
                "pure-Neumann problem (no Dirichlet face) with sigma=0 is "
                "singular (constant nullspace); add a Dirichlet face, a "
                "positive sigma shift, or a Robin face"
            )
        # Line blocks need the line axis unsharded (lines stay within a
        # shard); Schwarz blocks are cell-local, so any layout works.
        self._schwarz = smoother == "schwarz"
        self._line_axis = (None if self._schwarz else parse_line_smoother(
            smoother, mesh, kappa,
            allowed=tuple(a for a in range(3) if shards[a] == 1)))
        if self._line_axis is not None and shards[self._line_axis] != 1:
            raise ValueError(
                f"GridPMG smoother='line' along {'xyz'[self._line_axis]} "
                f"needs shards[{self._line_axis}]==1 (lines must not span "
                f"shards); got shards={shards} — pick an explicit "
                "'line-x|y|z' along an unsharded axis or re-layout"
            )
        if operator not in ("kron", "kron_blocked", "lattice",
                            "lattice_blocked", "dofmap"):
            raise ValueError(
                f"GridPMG: unknown operator backend {operator!r} "
                "(choose 'kron', 'kron_blocked', 'lattice', "
                "'lattice_blocked' or 'dofmap')"
            )
        kron_family = operator in ("kron", "kron_blocked")
        if kron_family:
            require_axis_aligned(mesh, f"GridPMG operator='{operator}'")
        if (operator in ("kron_blocked", "lattice_blocked")
                and dtype != torch.float32):
            raise ValueError(
                f"operator='{operator}' is f32-only (CUDA kernels); "
                f"got dtype={dtype}"
            )
        if coarse not in ("cg", "smoother", "fdm", "direct", "hmg"):
            raise ValueError(
                f"GridPMG: unsupported coarse solver '{coarse}' "
                "(choose from cg, smoother, fdm, direct, hmg)"
            )
        _check_precision(precision)
        self._kappa_raw = kappa
        self._kc, self._kappa_fold, const = resolve_kappa_split(mesh, kappa)
        # A tensor kappa folds into G (_kappa_fold); _kc is the per-cell
        # scalar (ones for a tensor), applied to G through scale_G.
        self.kappa_cells = (self._kappa_fold if self._kappa_fold is not None
                            else self._kc)
        self.kappa = float(self._kc[0]) if const else None
        # The forms the Kronecker family and the fdm coarse solves can
        # express (scalar, per-axis, diagonal tensor); JAX's ValueError for
        # the rest on the Kronecker family.
        try:
            self.kappa_axes = resolve_kappa_axes(
                mesh, kappa, split=(self._kc, self._kappa_fold, const))
        except ValueError:
            if kron_family:
                raise
            self.kappa_axes = None
        if coarse == "fdm":
            require_axis_aligned(mesh, "GridPMG coarse='fdm'")
            if self.kappa_axes is None:
                raise ValueError(
                    "GridPMG: coarse='fdm' is constant-coefficient "
                    "(scalar, per-axis or diagonal-tensor) only; use "
                    "'hmg', 'cg', 'smoother' or 'direct'"
                )
        self.mesh = mesh
        self.shards = shards
        # where the whole stack is built (the host on a rank, `_place`)
        self._bdev = self.grid.build_device(self.device)
        self.degrees = tuple(int(p) for p in degrees)
        self.dtype = dtype
        self.precision = precision
        self.coarse = coarse
        self.coarse_cfg = dict(coarse_cfg or {})
        self.operator_kind = operator
        self._kron = kron_family
        self.eigs = []
        # Robin faces on the general backends ride the baked pointwise
        # shift (the boundary mass folded into m3, scalar 1.0).
        self._ops_sigma = ops_shift_scalar(mesh, self.sigma, kron_family)
        g = self.grid
        if operator == "kron_blocked":
            ops = grid_kron_blocked_cycle_ops(g, precision, sigma=self.sigma)
        elif operator == "kron":
            ops = grid_kron_cycle_ops(g, precision, sigma=self.sigma)
        elif operator == "lattice_blocked":
            ops = grid_lattice_blocked_cycle_ops(g, precision,
                                                 sigma=self._ops_sigma)
        elif operator == "lattice":
            ops = grid_lattice_cycle_ops(g, precision, sigma=self._ops_sigma)
        else:
            ops = grid_dofmap_cycle_ops(g, sigma=self._ops_sigma)
        if coarse in ("fdm", "direct", "hmg"):
            coarse_gather, coarse_slice = grid_coarse_hooks(
                self.part, self.degrees[0], grid=g)
            ops = dict(ops, coarse_gather=coarse_gather,
                       coarse_slice=coarse_slice)
        self._ops = ops

        level_data, levels = [], []
        for Pdeg in self.degrees:
            lv = self._place(self._build_level(Pdeg))
            level = Level(P=Pdeg, ndofs=self.part.local_ndofs(Pdeg),
                          smoother_iters=smoother_iters,
                          shape=self.part.local_shape(Pdeg),
                          line_axis=(self._line_axis
                                     if self._line_axis is not None else 2))
            # Smoother calibration, as the JAX package runs it per shard:
            # recorded CG on A x = 1 from 0 preconditioned as the smoother
            # is (line, Schwarz or Jacobi), Lanczos, lmax inflated by 1.1.
            ones = torch.ones(g.block + level.shape, dtype=dtype,
                              device=self.device)
            _, info = cg_solve(
                lambda x, _lv=lv, _level=level: ops["apply"](_lv, x, _level),
                ones, torch.zeros_like(ones), lv["diag_inv"],
                rtol=DEFAULT_CALIBRATION_RTOL, maxiter=calibration_iters,
                record=True, dot=lambda u, v, _lv=lv: ops["dot"](u, v, _lv),
                precond=_level_precond(lv, level, ops),
            )
            eigs = lanczos_eigenvalue_estimates(
                info["alphas"].cpu().numpy(), info["betas"].cpu().numpy(),
                info["stored"].cpu().numpy(),
            )
            self.eigs.append(eigs)
            lv["lmax"] = torch.tensor(EIG_RANGE_FACTORS[1] * eigs[-1],
                                      dtype=dtype, device=self.device)
            level_data.append(lv)
            levels.append(level)
        self.levels = tuple(levels)

        from ..ops.lattice import axis_interpolation_matrix

        tensor = lambda a: torch.as_tensor(a, dtype=dtype, device=self.device)
        transfer = []
        for Pc, Pf in zip(self.degrees[:-1], self.degrees[1:]):
            tr = {"I" + name: tensor(axis_interpolation_matrix(
                self.part.cells_per_shard[a], Pc, Pf))
                for a, name in enumerate("xyz")}
            tr["weights_f"] = self._stacked(
                self.part.ownership_weights(Pf), dtype)
            transfer.append(self._place(tr, dict(weights_f=AXES)))
        self.data = dict(levels=level_data, transfer=transfer)
        if coarse == "direct":
            from ..solvers.pmg import dense_cholesky

            self.data["coarse_chol"] = torch.as_tensor(
                dense_cholesky(mesh, self.degrees[0], self.kappa_cells,
                               self.sigma, self._sigma_field),
                dtype=dtype, device=self.device)
        elif coarse == "fdm" and self.coarse_cfg.get("dist"):
            # The non-gathered form: pencil all_to_all transposes per
            # sharded axis (parallel/fdm_dist.py); the gather hooks go
            # unused on this branch.
            from .fdm_dist import make_fdm_dist

            fdm, spec, ops["fdm_dist"] = make_fdm_dist(
                mesh, self.degrees[0], self.part,
                tuple((AXES[a], shards[a]) if shards[a] > 1 else None
                      for a in range(3)), AXES, self.kappa_axes, dtype,
                precision=precision, sigma=self.sigma, device=self._bdev,
                grid=g)
            self.data["fdm"] = self._place(fdm, spec)
        elif coarse == "hmg":
            self._build_hmg(smoother_iters)
        elif coarse == "fdm":
            from ..solvers.fdm import FastDiagonalizationSolver

            fd = FastDiagonalizationSolver(
                mesh, self.degrees[0], kappa=self.kappa_axes, dtype=dtype,
                precision=precision, sigma=self.sigma, device=self.device,
            )
            self.data["fdm"] = dict(
                Vx=fd.Vs[0], Vy=fd.Vs[1], Vz=fd.Vs[2],
                Vxt=fd.Vts[0], Vyt=fd.Vts[1], Vzt=fd.Vts[2],
                dinv=fd.dinv, bc_global=fd.bc_marker,
            )
            self.coarse_cfg["fdm_shape"] = mesh.lattice_shape(self.degrees[0])
            self.coarse_cfg["fdm_trims"] = fd.trims

    def _build_hmg(self, smoother_iters):
        """The ``hmg`` coarse solve. Constant-kappa axis-aligned boxes ride
        the Kronecker h-hierarchy, the general family (curved hexes, DG-0
        or off-diagonal tensor kappa, a sigma field) the rediscretised
        lattice one. With ``coarse_cfg["dist"]`` every h-level stays in the
        stacked layout (`build_hmg_grid` / `build_hmg_grid_general`); else
        the gathered global hierarchy (`build_hmg` / `build_hmg_general`)
        is solved once on the stack."""
        from ..fem.assembly import ops_shift_scalar
        from ..solvers.hmg import build_hmg, build_hmg_general
        from ..solvers.pmg import kron_cycle_ops

        mesh, cfg, P0 = self.mesh, self.coarse_cfg, self.degrees[0]
        kw = dict(smoother_iters=smoother_iters, precision=self.precision,
                  bottom=cfg.get("bottom", "direct"),
                  min_cells=cfg.get("min_cells", 2), sigma=self.sigma,
                  sizes=cfg.get("sizes"), smoother=cfg.get("smoother", "cheb"),
                  device=self.device)
        box = (getattr(mesh, "is_axis_aligned", True)
               and self.kappa_axes is not None and self._sigma_field is None)
        if cfg.get("dist"):
            build = build_hmg_grid if box else build_hmg_grid_general
            kappa = self.kappa_axes if box else self._kappa_raw
            extra = {} if box else dict(sigma_field=self._sigma_field)
            kw.update(device=self._bdev)
            (levels, data, specs, bottom, gather, unslice,
             bottom_solve) = build(mesh, self.grid, P0, kappa, self.dtype,
                                   divisors=cfg.get("divisors"), **kw,
                                   **extra)
            data = self._place(data, specs)
            core = (grid_kron_cycle_ops(self.grid, self.precision,
                                        sigma=self.sigma)
                    if box else grid_lattice_cycle_ops(
                        self.grid, self.precision,
                        sigma=ops_shift_scalar(mesh, self.sigma)))
            hmg_ops = dict(core, coarse_gather=gather, coarse_slice=unslice)
            if bottom_solve is not None:
                hmg_ops["fdm_dist"] = bottom_solve
            cfg.update(hmg_dist=True)
        elif box:
            levels, data, bottom = build_hmg(mesh, P0, self.kappa_axes,
                                             self.dtype, **kw)
            hmg_ops = kron_cycle_ops(self.precision, sigma=self.sigma)
        else:
            levels, data, bottom, hmg_ops = build_hmg_general(
                mesh, P0, self._kappa_raw, self.dtype,
                sigma_field=self._sigma_field, **kw)
        self.data["hmg"] = data
        cfg.update(hmg_levels=levels, hmg_ops=hmg_ops, hmg_bottom=bottom,
                   cycles=cfg.get("cycles", 3))

    def _place(self, data, spec=None):
        """Set-up arrays built for the whole stack -> this grid's shards
        on the device (`StackedGrid.place` under ``spec``, default
        `grid_level_spec`), with the per-shard ``kb_blocks`` cut from the
        placed ``kb_mats``."""
        from ..ops.kron_blocked import shard_blocks

        spec = grid_level_spec(data, self.shards) if spec is None else spec
        out = self.grid.place(data, spec, self.device)
        if "kb_mats" in out:
            out["kb_blocks"] = shard_blocks(out["kb_mats"])
        return out

    def _stacked(self, dup, dtype=None):
        """A host array in JAX's duplicated layout -> the stacked layout
        on the build device."""
        t = torch.as_tensor(np.ascontiguousarray(dup), device=self._bdev)
        if dtype is not None:
            t = t.to(dtype)
        return stack_shards(t, self.shards)

    def _build_level(self, Pdeg, dtype=None, include_diag=True,
                     backend=None):
        """The per-level arrays under the JAX package's names, vectors in
        the stacked layout: ``bc_marker``, ``weights``, with
        ``include_diag`` ``diag_inv`` and the smoother's ``line_inv`` or
        ``schwarz``, ``m3`` (a general backend with a shift, a sigma field
        or Robin faces) and the arrays of ``backend`` (default: the
        hierarchy's): ``K*``/``m*`` (kron), ``kb_mats`` with its per-shard
        ``kb_blocks`` (kron_blocked), ``G`` and ``E*``/``D*`` (lattice),
        ``Gt`` and ``lb_mats`` (lattice_blocked), or ``dofmap``, ``G``,
        ``coeff`` and ``D`` (dofmap). `solve_refined` builds its float64
        fine level here."""
        from ..fem.assembly import general_shift_np
        from .dist import _shifted_diag_np

        dtype = dtype or self.dtype
        backend = backend or self.operator_kind
        part, mesh = self.part, self.mesh
        lv = dict(
            bc_marker=self._stacked(
                part.to_dist(Pdeg, mesh.boundary_dof_marker(Pdeg)) > 0.5),
            weights=self._stacked(part.ownership_weights(Pdeg), dtype),
        )
        if include_diag:
            lv["diag_inv"] = self._stacked(part.to_dist(
                Pdeg, 1.0 / _shifted_diag_np(
                    mesh, Pdeg, self.kappa_cells, self.sigma,
                    sigma_field=self._sigma_field)), dtype)
            if self._line_axis is not None:
                lv["line_inv"] = self._stacked_line_blocks(Pdeg)
            elif self._schwarz:
                lv["schwarz"] = self._stacked_schwarz(Pdeg)
        if self._ops_sigma and backend not in ("kron", "kron_blocked"):
            # sigma * (field-scaled) lumped mass, any Robin boundary mass
            # baked in (fem.assembly.general_shift_np).
            lv["m3"] = self._stacked(part.to_dist(Pdeg, general_shift_np(
                mesh, Pdeg, self.sigma, self._sigma_field)[1]), dtype)
        if backend in ("kron", "kron_blocked"):
            lv.update(self._kron_arrays(Pdeg, dtype, backend))
        elif backend == "dofmap":
            lv.update(self._dofmap_arrays(Pdeg, dtype))
        else:
            lv.update(self._lattice_arrays(Pdeg, dtype, backend))
        return lv

    def _kron_arrays(self, Pdeg, dtype, backend):
        """The Kronecker family's level arrays: the local per-shard axis
        stiffness and the duplicated-layout axis masses (``kron``), or the
        grid-stacked ``kb_mats`` (``kron_blocked``; `_place` cuts their
        per-shard ``kb_blocks``)."""
        from ..ops.kron import axis_stiffness_mass, local_axis_K

        part, mesh, shards = self.part, self.mesh, self.shards
        npls = part.local_shape(Pdeg)
        Ks_local, ms_dup = [], []
        for a in range(3):
            Kl, _ = local_axis_K(mesh, a, part.cells_per_shard[a], Pdeg,
                                 self.kappa_axes[a], shards[a])
            _, mg = axis_stiffness_mass(mesh.nc[a], Pdeg, mesh.h_cells[a])
            Ks_local.append(Kl)
            ms_dup.append(duplicate_planes(mg, npls[a], shards[a]))
        if backend == "kron_blocked":
            from ..ops.kron_blocked import (
                checked_face_masks,
                grid_symmetrized_mats,
            )

            fm = checked_face_masks(mesh, Pdeg,
                                    mesh.boundary_dof_marker(Pdeg))
            fm_dup = None if fm is None else tuple(
                duplicate_planes(fm[a], npls[a], shards[a]) for a in range(3))
            kb, _ = grid_symmetrized_mats(
                Ks_local, ms_dup, shards, dtype, fm_dup, band=Pdeg,
                device=self._bdev)
            return dict(kb_mats=kb)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=self._bdev)
        out = {}
        for a, name in enumerate("xyz"):
            out["K" + name] = t(Ks_local[a])
            out["m" + name] = t(ms_dup[a])
        return out

    def _lattice_arrays(self, Pdeg, dtype, backend):
        """The lattice backends' level arrays: the global quadrature-lattice
        geometry (kappa folded in: a DG-0 kappa through `scale_G`, a tensor
        through the geometry factors) cut per shard, as ``G`` with the
        LOCAL axis matrices (``lattice``) or as K-A's ``Gt`` with
        ``lb_mats`` (``lattice_blocked``)."""
        from ..fem.assembly import geometry_factors_np, scale_G
        from ..ops.lattice import geometry_to_qlattice, lattice_mats

        part, mesh = self.part, self.mesh
        G_cells, _ = geometry_factors_np(mesh, Pdeg, kappa=self._kappa_fold)
        Gq = torch.as_tensor(geometry_to_qlattice(
            scale_G(G_cells, self._kc, self._kappa_fold), mesh.nc, Pdeg),
            dtype=dtype, device=self._bdev)
        if backend == "lattice_blocked":
            from ..ops.lattice_blocked import lattice_blocked_mats

            return dict(Gt=stack_gfirst(Gq, self.shards),
                        lb_mats=lattice_blocked_mats(
                            part.cells_per_shard, Pdeg, dtype,
                            device=self._bdev))
        return dict(lattice_mats(part.cells_per_shard, Pdeg, dtype,
                                 self._bdev),
                    G=stack_blocks(Gq, self.shards))

    def _dofmap_arrays(self, Pdeg, dtype):
        """The dofmap backend's level arrays: the per-cell ``G`` (a tensor
        kappa folded in) and ``coeff`` cut per shard (the global cell order
        is x slowest, z fastest, so ``(ncells, ...)`` reshapes to ``(ncx,
        ncy, ncz, ...)``), the shard's LOCAL box dofmap and ``D``."""
        from ..fem.assembly import geometry_factors_np
        from ..fem.gll import derivative_matrix
        from ..fem.mesh import BoxMesh

        part, mesh, shards = self.part, self.mesh, self.shards
        G_cells, _ = geometry_factors_np(mesh, Pdeg, kappa=self._kappa_fold)
        nq = G_cells.shape[1]
        t = lambda a: torch.tensor(np.asarray(a), dtype=dtype,
                                   device=self._bdev)
        return dict(
            G=stack_blocks(t(G_cells.reshape(tuple(mesh.nc) + (nq, 6))),
                           shards).reshape(shards + (-1, nq, 6)),
            coeff=stack_blocks(t(self._kc.reshape(tuple(mesh.nc))),
                               shards).reshape(shards + (-1,)),
            dofmap=torch.tensor(BoxMesh(part.cells_per_shard).dofmap(Pdeg),
                                dtype=torch.int64, device=self._bdev),
            D=t(derivative_matrix(Pdeg)),
        )

    def _stacked_line_blocks(self, Pdeg):
        """The global line-block inverses in the stacked layout
        (`stacked_line_blocks`)."""
        from ..solvers.line import line_block_inverses

        return stacked_line_blocks(
            line_block_inverses(self.mesh, Pdeg, self._kappa_raw,
                                self._line_axis, sigma=self.sigma),
            self.part, Pdeg, self._line_axis, self.dtype, self._bdev)

    def _stacked_schwarz(self, Pdeg):
        """The global Schwarz data in the stacked layout
        (`stacked_schwarz`)."""
        from ..solvers.schwarz import build_schwarz_np

        swg = build_schwarz_np(self.mesh, Pdeg, self._kappa_raw,
                               sigma=self.sigma)
        return stacked_schwarz(swg, self.part, Pdeg, self.dtype, self._bdev)

    # -- API -------------------------------------------------------------

    @property
    def ops(self):
        """The cycle-ops dict (apply/residual/restrict/prolong/dot/zeros
        and the coarse hooks) on the stacked layout."""
        return self._ops

    def to_dist(self, u, level=-1):
        """A global flat vector (numpy or tensor) -> the stacked layout on
        the device, in the working dtype."""
        return self._dist(u, level, self.dtype)

    def _dist(self, u, level, dtype):
        """`to_dist` in ``dtype`` (a rank cuts its block before the
        upload)."""
        glob = self.mesh.lattice_shape(self.degrees[level])
        return self.grid.put_local(
            torch.as_tensor(u).reshape(glob),
            self.part.local_shape(self.degrees[level]), device=self.device,
            dtype=dtype)

    def from_dist(self, ud, level=-1):
        """The stacked layout -> the global flat vector (a tensor on the
        device); ``level`` keeps the JAX signature (the stacked shape
        already names the level)."""
        return self.grid.all_gather(ud).reshape(-1)

    def load_state(self, data):
        """Overwrite the level, transfer and coarse arrays (the calibrated
        ``lmax`` included) with those of ``data`` — the port's layout, e.g.
        from `utils.convert.grid_data_from_numpy` of the JAX `GridPMG`'s
        data — so cycles can be compared apart from calibration. Keys
        ``data`` does not hold keep their values; shapes must match. The
        per-shard ``kb_blocks`` are cut anew from the merged ``kb_mats``."""
        from ..ops.kron_blocked import shard_blocks

        for i, lv in enumerate(data["levels"]):
            mine = self.data["levels"][i]
            _merge_state(mine, lv, f"levels[{i}]")
            if "kb_blocks" in mine:
                mine["kb_blocks"] = shard_blocks(mine["kb_mats"])
        for i, tr in enumerate(data.get("transfer", ())):
            _merge_state(self.data["transfer"][i], tr, f"transfer[{i}]")
        for key in ("fdm", "hmg", "coarse_chol"):
            if key in data and key in self.data:
                if key == "coarse_chol":
                    _merge_state(self.data, {key: data[key]}, key)
                else:
                    _merge_state(self.data[key], data[key], key)

    def _vcycle(self, b, u):
        return v_cycle(self.data, b, u, levels=self.levels,
                       coarse=self.coarse, coarse_cfg=self.coarse_cfg,
                       ops=self._ops)

    def _fine_apply(self, x):
        return self._ops["apply"](self.data["levels"][-1], x, self.levels[-1])

    def _fmg_guess(self, bd):
        return fmg_initial_guess(self.data, bd, levels=self.levels,
                                 coarse=self.coarse,
                                 coarse_cfg=self.coarse_cfg, ops=self._ops)

    def _warn_tensor(self):
        from ..solvers.pmg import warn_tensor_stationary

        warn_tensor_stationary(self._kappa_fold, self.kappa_axes,
                               self.operator_kind,
                               line=(self._line_axis is not None
                                     or self._schwarz))

    def apply(self, bd, ud):
        """One V-cycle on stacked vectors."""
        return self._vcycle(bd, ud)

    def solve(self, b, num_cycles=10, residuals=True, u0=None, fmg=False):
        """Stationary V-cycle iteration from zero (``u0`` resumes from an
        iterate, ``fmg=True`` starts from the full-multigrid guess).
        Returns ``(u, residual_norms)``: the global flat solution on the
        device and the fine residual norm after each cycle, read back once
        at the end."""
        from ..solvers.pmg import warn_high_precision_stationary

        warn_high_precision_stationary(
            self.precision, self.mesh.num_dofs(self.degrees[-1]))
        self._warn_tensor()
        bd = self.to_dist(b)
        if u0 is not None:
            ud = self.to_dist(u0)
        elif fmg:
            ud = self._fmg_guess(bd)
        else:
            ud = torch.zeros_like(bd)
        lvf = self.data["levels"][-1]
        norms = []
        for _ in range(num_cycles):
            ud = self._vcycle(bd, ud)
            r = bd - self._fine_apply(ud)
            norms.append(torch.sqrt(self._ops["dot"](r, r, lvf)))
        out = self.from_dist(ud)
        if not residuals or not norms:
            return out, []
        return out, [float(v) for v in torch.stack(norms).cpu().numpy()]

    def solve_pcg(self, b, rtol=1e-8, maxiter=50, fmg=False):
        """V-cycle-preconditioned flexible CG over the grid from zero (or
        the FMG guess). Returns ``(u, niter)``; the loop reads its
        convergence flag on the host once per iteration."""
        from ..solvers.cg import fcg_solve

        lvf = self.data["levels"][-1]
        bd = self.to_dist(b)
        u0 = self._fmg_guess(bd) if fmg else torch.zeros_like(bd)
        u, info = fcg_solve(
            self._fine_apply, bd, u0,
            lambda r: self._vcycle(r, torch.zeros_like(r)),
            rtol=float(rtol), maxiter=int(maxiter),
            dot=lambda u_, v_: self._ops["dot"](u_, v_, lvf),
        )
        return self.from_dist(u), int(info["niter"])

    def _refine_apply64(self):
        """``(lv64, apply64)`` of `solve_refined`: the float64 fine level
        (`_build_level` without diagonal; the f32-only kernels pair with
        their plain twins, ``lattice_blocked`` with ``lattice`` and
        ``kron_blocked`` with ``kron``, the same discrete operator) and its
        stacked apply; built once."""
        if getattr(self, "_apply64", None) is None:
            kind = self.operator_kind
            backend = {"lattice_blocked": "lattice",
                       "kron_blocked": "kron"}.get(kind, kind)
            lv64 = self._place(self._build_level(
                self.degrees[-1], torch.float64, include_diag=False,
                backend=backend))
            g = self.grid
            if backend == "kron":
                ops64 = grid_kron_cycle_ops(g, sigma=self.sigma)
            elif backend == "dofmap":
                ops64 = grid_dofmap_cycle_ops(g, sigma=self._ops_sigma)
            else:
                ops64 = grid_lattice_cycle_ops(g, sigma=self._ops_sigma)
            self._apply64 = (lv64, ops64["apply"])
        return self._apply64

    def solve_refined(self, b, num_cycles=15, rtol=0.0, residuals=True,
                      u0=None, fmg=False):
        """Mixed-precision iterative refinement over the grid: a float64
        residual through the f64 fine-level apply (`_refine_apply64`) with
        the working-dtype V-cycle as the error smoother, on every backend.
        ``u0`` resumes from an iterate, ``fmg=True`` starts from the
        working-dtype FMG guess. Returns ``(u64, residual_norms)`` (the f64
        residual norm before each cycle); with ``rtol`` the loop stops once
        it falls below ``rtol * |b|``, reading the norm once per cycle."""
        self._warn_tensor()
        lv64, apply64 = self._refine_apply64()
        f64, fine = torch.float64, self.levels[-1]
        b64 = self._dist(b, -1, f64)
        if u0 is not None:
            u64 = self._dist(u0, -1, f64)
        elif fmg:
            u64 = self._fmg_guess(b64.to(self.dtype)).to(f64)
        else:
            u64 = torch.zeros_like(b64)
        r0 = (float(np.linalg.norm(np.asarray(
            torch.as_tensor(b).detach().cpu(), dtype=np.float64)))
            if rtol else None)
        norms = []
        for _ in range(num_cycles):
            r64 = b64 - apply64(lv64, u64, fine)
            rn = torch.sqrt(self.grid.dot(r64, r64, lv64["weights"]))
            r = r64.to(self.dtype)
            u64 = u64 + self._vcycle(r, torch.zeros_like(r)).to(f64)
            norms.append(rn)
            if rtol and float(rn) < rtol * r0:
                break
        rnorms = ([float(v) for v in torch.stack(norms).cpu().numpy()]
                  if residuals and norms else [])
        return self.from_dist(u64), rnorms
