"""2D/3D device-grid decomposition of the Kronecker family, every shard
stacked on one device.

Port of `pmg_dolfinx_tpu.parallel.grid2d` for the ``"kron"`` and
``"kron_blocked"`` backends. The lattice is split into ``(sx, sy, sz)``
boxes (any factor may be 1) with the interface planes duplicated along
every sharded axis; ownership weights (the product of per-axis masks)
count each dof once in a reduction. The three Kronecker terms are
axis-separable: the K_a term is shard-partial only across a-interfaces,
so one neighbour exchange per sharded axis reconciles everything, with no
corner or diagonal communication.

Layout. JAX runs `GridPMG` as one ``shard_map`` program over a device
mesh. The port runs the same SPMD program with all shards stacked on one
device: a distributed vector is ONE tensor of shape ``(sx, sy, sz, nplx,
nply, nplz)``, shard-major, so each shard's block is contiguous and a
kernel takes it without a copy. Pointwise work (axpy, the bc ``where``,
the Chebyshev and FCG updates) runs on the whole tensor; per-shard work
(kernels 1 and 2 of ``kron_blocked``, the per-shard einsums) runs on the
blocks. The JAX package's public duplicated layout ``(sx*nplx, sy*nply,
sz*nplz)`` is what `GridPartition.to_dist` gives; `stack_shards` /
`unstack_shards` convert between the two.

The seam. Every collective of the JAX program goes through one object,
`StackedGrid`: the non-wrapping ``ppermute`` of a plane along a grid axis,
the ``psum`` of a dot, and the ``all_gather`` / ``dynamic_slice`` of the
global coarse solve. On the stacked layout each is an exact tensor
operation on the three leading (shard) axes.

Smoothers: point Jacobi, line relaxation along an unsharded axis (the
global block inverses laid out like the vectors, `_stacked_line_blocks`)
and the cell-wise Schwarz blocks (per-shard dense axis transforms,
`_stacked_schwarz`, the overlap-add reconciled by the grid exchange).
Coarse solves: ``cg``, ``smoother`` and the gathered ``fdm`` and
``direct``.

Not ported here (ROADMAP.md Queue 1 item 10 unless named): the lattice,
lattice_blocked and dofmap grid backends, the ``hmg`` coarse solver and
``coarse_cfg["dist"]``, `build_hmg_grid(_general)`, sigma fields,
per-axis, tensor and per-cell kappa, Robin faces and graded spacing,
``solve_refined``, ``devices`` (the multi-process backend) and
``precision="high"`` (item 1). Each raises NotImplementedError naming
its item.
"""

import numpy as np
import torch

from ..ops.blas import dist_inner_product
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


def _todo(what, item):
    return NotImplementedError(
        f"GridPMG: {what} is not ported yet (ROADMAP.md Queue 1 item {item})")


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


def stack_shards(dup, shards):
    """JAX's duplicated layout ``(sx*nplx, sy*nply, sz*nplz)`` (a tensor)
    -> the stacked ``(sx, sy, sz, nplx, nply, nplz)`` layout, contiguous."""
    sx, sy, sz = shards
    X, Y, Z = dup.shape
    return (dup.reshape(sx, X // sx, sy, Y // sy, sz, Z // sz)
            .permute(0, 2, 4, 1, 3, 5).contiguous())


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
    (the ``psum`` of an ownership-weighted dot), `all_gather` (the global
    lattice, duplicated planes stripped) and `local_slices` (each shard's
    ``dynamic_slice`` of a global lattice at its ``axis_index``).

    This object is the port's one seam for communication. A multi-process
    backend (``torch.distributed``, one rank per shard) holds a ``(1, 1, 1,
    nplx, nply, nplz)`` block per rank and replaces only this object: a
    neighbour send/receive for `ppermute_planes`, an ``all_reduce`` for
    `dot`, an ``all_gather`` for `all_gather`, its own block for
    `local_slices`. Every caller stays as it is.
    """

    def __init__(self, shards):
        self.shards = _norm_shards(shards)

    def ppermute_planes(self, first, last, axis):
        """Non-wrapping ``ppermute`` along grid axis ``axis`` of per-shard
        planes (leading dims the shard axes): returns ``(from_left,
        from_right)`` with ``from_left[s] = last[s - 1]`` and
        ``from_right[s] = first[s + 1]``, zeros at the chain ends. Both
        are new tensors: the planes are read before anyone adds them."""
        S = self.shards[axis]
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
        at ``axis_index * (npl - 1)`` per sharded axis), stacked."""
        nx, ny, nz = local_shape
        blocks = (lat.unfold(0, nx, nx - 1).unfold(1, ny, ny - 1)
                  .unfold(2, nz, nz - 1))
        return blocks.contiguous()


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
    stacked ``t`` (one matrix for all shards)."""
    eq = ("ax,...xyz->...ayz", "by,...xyz->...xbz", "cz,...xyz->...xyc")
    return torch.einsum(eq[dim], M, t)


def _grid_common_ops(shards, precision):
    """The backend-independent V-cycle primitives on the box partition:
    transfers (ownership-weighted restriction with one exchange per
    sharded axis; prolongation needs none) and the ownership-weighted
    dot."""
    from ..ops.kron_blocked import _check_precision

    _check_precision(precision)
    grid = StackedGrid(shards)

    def restrict_op(tr, r, level_c, level_f):
        lat = r * tr["weights_f"]
        for dim, name in enumerate(("Ix", "Iy", "Iz")):
            lat = _stacked_contract(tr[name].T, lat, dim)
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
            grid.shards + tuple(level.shape), dtype=like.dtype,
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
    exchange along its own axis; stacked lattice vectors throughout."""
    shards = _norm_shards(shards)
    grid = StackedGrid(shards)

    def apply_op(lv, x, level):
        (Sx, Sy, Sz), (nx, ny, nz) = shards, level.shape
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

    return dict(_grid_common_ops(shards, precision), apply=apply_op)


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

    shards = _norm_shards(shards)
    grid = StackedGrid(shards)
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

    return dict(_grid_common_ops(shards, "highest"), apply=apply_op,
                residual=residual_op)


def grid_coarse_hooks(part, P0):
    """Gather/slice hooks of the global coarse solve on the box partition:
    ``coarse_gather`` takes the stacked coarse vector to the global
    lattice (the duplicated interface planes stripped), ``coarse_slice``
    a global lattice (or flat vector) back to the stacked layout."""
    grid = StackedGrid(part.shards)
    npls = part.local_shape(P0)
    glob = part.mesh.lattice_shape(P0)

    def coarse_gather(b0_local):
        return grid.all_gather(b0_local)

    def coarse_slice(ug):
        return grid.local_slices(ug.reshape(glob), npls)

    return coarse_gather, coarse_slice


class GridPMG:
    """p-multigrid over a 2D/3D device grid, every shard stacked on one
    device (``device``, CUDA unless the caller asks for the CPU).

    The JAX package's signature: operator backends ``"kron"`` (plain
    torch, any float dtype) and ``"kron_blocked"`` (the CUDA kernels,
    float32); coarse solvers ``"cg"`` (default), ``"smoother"`` and the
    gathered ``"fdm"`` and ``"direct"``; smoothers ``"cheb"`` (point
    Jacobi), ``"line"`` / ``"line-x|y|z"`` (the line axis unsharded) and
    ``"schwarz"`` (any layout); scalar ``kappa`` and ``sigma``. Methods `solve`, `solve_pcg`, `to_dist`,
    `from_dist` and `load_state`; vectors in and out are global flat
    vectors (numpy or tensors in, tensors on ``device`` out).
    """

    def __init__(self, mesh, shards=(2, 2), degrees=(1, 3), kappa=2.0,
                 dtype=torch.float64, smoother_iters=DEFAULT_SMOOTHER_ITERS,
                 coarse="cg", coarse_cfg=None, devices=None,
                 calibration_iters=DEFAULT_CALIBRATION_ITERS,
                 operator="kron", precision="highest", sigma=0.0,
                 smoother="cheb", *, device="cuda"):
        from ..fem.assembly import resolve_kappa_axes, resolve_kappa_split
        from ..fem.mesh import require_axis_aligned

        self.part = GridPartition(mesh, shards)
        shards = self.part.shards
        if devices is not None:
            raise _todo("devices= (the multi-process torch.distributed "
                        "backend; the port stacks every shard on one "
                        "device)", 10)
        if callable(sigma):
            if operator in ("kron", "kron_blocked"):
                raise ValueError(
                    "a sigma FIELD (callable) requires a general backend "
                    "— the Kronecker paths carry only a separable scalar "
                    "shift"
                )
            raise _todo("a sigma field", 10)
        self.sigma = float(sigma)
        if getattr(mesh, "has_robin", False):
            raise _todo("Robin faces", 10)
        if getattr(mesh, "is_graded", False):
            raise _todo("graded spacing", 10)
        if (not any(any(f) for f in getattr(mesh, "dirichlet_faces",
                                            ((True, True),) * 3))
                and self.sigma == 0.0):
            raise ValueError(
                "pure-Neumann problem (no Dirichlet face) with sigma=0 is "
                "singular (constant nullspace); add a Dirichlet face, a "
                "positive sigma shift, or a Robin face"
            )
        # Line blocks need the line axis unsharded (lines stay within a
        # shard); Schwarz blocks are cell-local, so any layout works.
        from ..solvers.line import parse_line_smoother

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
        if operator not in ("kron", "kron_blocked"):
            raise _todo(f"operator={operator!r}", 10)
        require_axis_aligned(mesh, f"GridPMG operator='{operator}'")
        if operator == "kron_blocked" and dtype != torch.float32:
            raise ValueError(
                f"operator='{operator}' is f32-only (CUDA kernels); "
                f"got dtype={dtype}"
            )
        if coarse not in ("cg", "smoother", "fdm", "direct", "hmg"):
            raise ValueError(
                f"GridPMG: unsupported coarse solver '{coarse}' "
                "(choose from cg, smoother, fdm, direct, hmg)"
            )
        if coarse == "hmg":
            raise _todo("coarse='hmg'", "10")
        if (coarse_cfg or {}).get("dist"):
            raise _todo("coarse_cfg['dist'] (the non-gathered coarse solve)",
                        10)
        if precision == "high":
            raise _todo("precision='high' (bf16x3 products)", 1)
        if precision != "highest":
            raise ValueError(
                f"precision must be 'highest' or 'high', got {precision!r}")
        kc, kt, const = resolve_kappa_split(mesh, kappa)
        if kt is not None or not const:
            raise _todo("a per-axis, tensor or per-cell kappa", 10)
        self.kappa_axes = resolve_kappa_axes(mesh, kappa,
                                             split=(kc, kt, const))
        self._kappa_cells = kc
        self.kappa = float(kc[0])
        self.mesh = mesh
        self.shards = shards
        self.grid = StackedGrid(shards)
        self.degrees = tuple(int(p) for p in degrees)
        self.device = torch.device(device)
        self.dtype = dtype
        self.precision = precision
        self.coarse = coarse
        self.coarse_cfg = dict(coarse_cfg or {})
        self.operator_kind = operator
        self.eigs = []
        if operator == "kron_blocked":
            ops = grid_kron_blocked_cycle_ops(shards, precision,
                                              sigma=self.sigma)
        else:
            ops = grid_kron_cycle_ops(shards, precision, sigma=self.sigma)
        if coarse in ("fdm", "direct"):
            coarse_gather, coarse_slice = grid_coarse_hooks(
                self.part, self.degrees[0])
            ops = dict(ops, coarse_gather=coarse_gather,
                       coarse_slice=coarse_slice)
        self._ops = ops

        level_data, levels = [], []
        for Pdeg in self.degrees:
            lv = self._build_level(Pdeg)
            level = Level(P=Pdeg, ndofs=self.part.local_ndofs(Pdeg),
                          smoother_iters=smoother_iters,
                          shape=self.part.local_shape(Pdeg),
                          line_axis=(self._line_axis
                                     if self._line_axis is not None else 2))
            # Smoother calibration, as the JAX package runs it per shard:
            # recorded CG on A x = 1 from 0 preconditioned as the smoother
            # is (line, Schwarz or Jacobi), Lanczos, lmax inflated by 1.1.
            ones = torch.ones(shards + level.shape, dtype=dtype,
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
            transfer.append(tr)
        self.data = dict(levels=level_data, transfer=transfer)
        if coarse == "direct":
            from ..solvers.pmg import dense_cholesky

            self.data["coarse_chol"] = torch.as_tensor(
                dense_cholesky(mesh, self.degrees[0], self.kappa, self.sigma),
                dtype=dtype, device=self.device)
        elif coarse == "fdm":
            from ..solvers.fdm import FastDiagonalizationSolver

            fd = FastDiagonalizationSolver(
                mesh, self.degrees[0], kappa=self.kappa, dtype=dtype,
                precision=precision, sigma=self.sigma, device=self.device,
            )
            self.data["fdm"] = dict(
                Vx=fd.Vs[0], Vy=fd.Vs[1], Vz=fd.Vs[2],
                Vxt=fd.Vts[0], Vyt=fd.Vts[1], Vzt=fd.Vts[2],
                dinv=fd.dinv, bc_global=fd.bc_marker,
            )
            self.coarse_cfg["fdm_shape"] = mesh.lattice_shape(self.degrees[0])
            self.coarse_cfg["fdm_trims"] = fd.trims

    def _stacked(self, dup, dtype=None):
        """A host array in JAX's duplicated layout -> the stacked layout
        on the device."""
        t = torch.as_tensor(np.ascontiguousarray(dup), device=self.device)
        if dtype is not None:
            t = t.to(dtype)
        return stack_shards(t, self.shards)

    def _build_level(self, Pdeg):
        """The per-level arrays under the JAX package's names, vectors in
        the stacked layout: ``bc_marker``, ``weights``, ``diag_inv`` and
        the backend's ``K*``/``m*`` (kron) or ``kb_mats`` (kron_blocked,
        grid-stacked) with its per-shard ``kb_blocks``, and the smoother's
        ``line_inv`` or ``schwarz``."""
        from ..ops.kron import axis_stiffness_mass, local_axis_K
        from .dist import _shifted_diag_np

        part, mesh, dtype = self.part, self.mesh, self.dtype
        shards = self.shards
        lv = dict(
            bc_marker=self._stacked(
                part.to_dist(Pdeg, mesh.boundary_dof_marker(Pdeg)) > 0.5),
            weights=self._stacked(part.ownership_weights(Pdeg), dtype),
            diag_inv=self._stacked(part.to_dist(Pdeg, 1.0 / _shifted_diag_np(
                mesh, Pdeg, self._kappa_cells, self.sigma)), dtype),
        )
        if self._line_axis is not None:
            lv["line_inv"] = self._stacked_line_blocks(Pdeg)
        elif self._schwarz:
            lv["schwarz"] = self._stacked_schwarz(Pdeg)
        npls = part.local_shape(Pdeg)
        Ks_local, ms_dup = [], []
        for a in range(3):
            Kl, _ = local_axis_K(mesh, a, part.cells_per_shard[a], Pdeg,
                                 self.kappa_axes[a], shards[a])
            _, mg = axis_stiffness_mass(mesh.nc[a], Pdeg, mesh.h_cells[a])
            Ks_local.append(Kl)
            ms_dup.append(duplicate_planes(mg, npls[a], shards[a]))
        if self.operator_kind == "kron_blocked":
            from ..ops.kron_blocked import (
                checked_face_masks,
                grid_symmetrized_mats,
                shard_blocks,
            )

            fm = checked_face_masks(mesh, Pdeg,
                                    mesh.boundary_dof_marker(Pdeg))
            fm_dup = None if fm is None else tuple(
                duplicate_planes(fm[a], npls[a], shards[a]) for a in range(3))
            lv["kb_mats"], _ = grid_symmetrized_mats(
                Ks_local, ms_dup, shards, dtype, fm_dup, band=Pdeg,
                device=self.device)
            lv["kb_blocks"] = shard_blocks(lv["kb_mats"])
        else:
            for a, name in enumerate("xyz"):
                lv["K" + name] = torch.as_tensor(Ks_local[a], dtype=dtype,
                                                 device=self.device)
                lv["m" + name] = torch.as_tensor(ms_dup[a], dtype=dtype,
                                                 device=self.device)
        return lv

    def _stacked_line_blocks(self, Pdeg):
        """The global line-block inverses in the stacked layout: ``(sx, sy,
        sz, npl_a, npl_b, n, n)`` over the two non-line axes ``a < b`` (the
        line axis's shard dim is 1), duplicated lines holding identical
        blocks; `line_precond_apply` reads them in the order of the
        stacked vector with the line axis moved last."""
        from ..solvers.line import line_block_inverses, shard_line_blocks

        part, axis = self.part, self._line_axis
        others = [a for a in range(3) if a != axis]
        dup = shard_line_blocks(
            line_block_inverses(self.mesh, Pdeg, self.kappa, axis,
                                sigma=self.sigma),
            self.mesh.lattice_shape(Pdeg), axis,
            [part._axis_starts(Pdeg, a) for a in others])
        (s0, s1), (n0, n1) = ((self.shards[a] for a in others),
                              (part.local_shape(Pdeg)[a] for a in others))
        n = dup.shape[-1]
        st = (torch.as_tensor(dup, dtype=self.dtype, device=self.device)
              .reshape(s0, n0, s1, n1, n, n).permute(0, 2, 1, 3, 4, 5))
        return st.unsqueeze(axis).contiguous()

    def _stacked_schwarz(self, Pdeg):
        """The global Schwarz data in the stacked layout: each dense axis
        transform as per-shard blocks ``(S_a, ncl_a*n, npl_a)``
        (`shard_dense_axis`), ``ginv`` cut cell-contiguously per shard and
        the marker in the duplicated-plane layout."""
        from ..solvers.schwarz import build_schwarz_np, shard_dense_axis

        part, dtype = self.part, self.dtype
        swg = build_schwarz_np(self.mesh, Pdeg, self.kappa, sigma=self.sigma)
        sw = {k: torch.as_tensor(
            shard_dense_axis(swg[k], Pdeg, *part._axis_starts(Pdeg, a)),
            dtype=dtype, device=self.device).reshape(self.shards[a], -1,
                                                     part.local_shape(Pdeg)[a])
            for a, k in enumerate(("Ux", "Uy", "Uz"))}
        sw["ginv"] = stack_shards(torch.as_tensor(
            swg["ginv"], dtype=dtype, device=self.device), self.shards)
        sw["bc"] = self._stacked(part.to_dist(
            Pdeg, np.asarray(swg["bc"], np.float64)) > 0.5)
        return sw

    # -- API -------------------------------------------------------------

    @property
    def ops(self):
        """The cycle-ops dict (apply/residual/restrict/prolong/dot/zeros
        and the coarse hooks) on the stacked layout."""
        return self._ops

    def to_dist(self, u, level=-1):
        """A global flat vector (numpy or tensor) -> the stacked layout on
        the device, in the working dtype."""
        glob = self.mesh.lattice_shape(self.degrees[level])
        u = torch.as_tensor(u).to(device=self.device, dtype=self.dtype)
        return self.grid.local_slices(u.reshape(glob),
                                      self.part.local_shape(
                                          self.degrees[level]))

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
        if "fdm" in data and "fdm" in self.data:
            _merge_state(self.data["fdm"], data["fdm"], "fdm")

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

    def apply(self, bd, ud):
        """One V-cycle on stacked vectors."""
        return self._vcycle(bd, ud)

    def solve(self, b, num_cycles=10, residuals=True, u0=None, fmg=False):
        """Stationary V-cycle iteration from zero (``u0`` resumes from an
        iterate, ``fmg=True`` starts from the full-multigrid guess).
        Returns ``(u, residual_norms)``: the global flat solution on the
        device and the fine residual norm after each cycle, read back once
        at the end."""
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

    def solve_refined(self, *args, **kwargs):
        raise _todo("solve_refined on the device grid", 10)
