"""The p-multigrid V-cycle preconditioner.

Port of `pmg_dolfinx_tpu.solvers.pmg`: the operator backends
``"dofmap"`` (gather / cell kernel / scatter, `ops/laplacian.py`; the
default), ``"lattice"`` (general hexes, plain torch einsums),
``"lattice_blocked"`` (general hexes, the CUDA kernels of
`ops/lattice_blocked.py`), ``"kron"`` and ``"kron_blocked"`` (axis-aligned
boxes, plain torch / the CUDA kernels of `ops/kron_blocked.py`); the
V-cycle with a ``"smoother"``, ``"cg"`` or ``"fdm"`` coarse solve, CG +
Lanczos smoother calibration, and the stationary (`solve`) and FCG
(`solve_pcg`) outer iterations. The Kronecker family keeps vectors
lattice-shaped ``(NX, NY, NZ)`` inside the cycle, the general family
flat; the public methods take and return flat vectors.

Cycle structure (operation for operation as in the JAX package):

    u[top] = u_in, b[top] = b_in, u[i < top] = 0
    DOWN  for i = top..1:
        pre-smooth  u[i] <- Chebyshev4(A_i, b[i], u[i])
        residual    r = b[i] - A_i u[i]
        restrict    b[i-1] = I_i^T r
    COARSE: b[0] *= (1 - bc_marker); u[0] = coarse_solve(b[0])
    UP    for i = 0..top-1:
        prolong     u[i+1] += I_i u[i]
        post-smooth u[i+1] <- Chebyshev4(A_{i+1}, b[i+1], u[i+1])

Everything else the JAX module offers raises NotImplementedError naming
its ROADMAP.md item.
"""

from dataclasses import dataclass

import torch

from ..ops.blas import inner_product
from .cg import cg_solve
from .chebyshev import chebyshev4_solve
from .tridiag import lanczos_eigenvalue_estimates

DEFAULT_SMOOTHER_ITERS = 2
DEFAULT_CALIBRATION_ITERS = 20
DEFAULT_CALIBRATION_RTOL = 1e-6
EIG_RANGE_FACTORS = (0.1, 1.1)

_OPERATORS = ("dofmap", "lattice", "lattice_blocked", "kron",
              "kron_blocked")
_OPERATOR_TODO = ("operator='csr' (assembled sparse matvec) and 'dss' "
                  "(unstructured row gathers) are not ported yet; they are "
                  "ROADMAP.md Queue 1 items 6 and 8")
_SIGMA_FIELD_TODO = ("a sigma FIELD (callable) on the general backends is "
                     "not ported yet (ROADMAP.md Queue 1 item 7)")
_COARSE_TODO = ("only coarse='smoother', 'cg' and 'fdm' are ported; "
                "'direct', 'hmg' and 'amg' are ROADMAP.md Queue 1 items 4 "
                "and 7")
_CYCLE_TODO = ("W-cycles (gamma > 1) and FMG are ROADMAP.md Queue 1 "
               "item 7")


@dataclass(frozen=True)
class Level:
    """Static metadata for one p-level (arrays live in the data dict)."""

    P: int
    ndofs: int
    smoother_iters: int = DEFAULT_SMOOTHER_ITERS
    shape: tuple | None = None


def _generic_calibration(lv, b, x0, *, ops, level, maxiter):
    A = lambda x: ops["apply"](lv, x, level)
    return cg_solve(
        A, b, x0, lv["diag_inv"],
        rtol=DEFAULT_CALIBRATION_RTOL, maxiter=maxiter, record=True,
        dot=lambda u, v: ops["dot"](u, v, lv),
    )


def _zeros(flat):
    """The ``zeros`` cycle primitive: flat ``(ndofs,)`` vectors for the
    general family, lattice-shaped ones for the Kronecker family."""
    return lambda level, like: torch.zeros(
        level.ndofs if flat else level.shape, dtype=like.dtype,
        device=like.device)


def _lattice_transfers(flat=False):
    from ..ops.lattice import lattice_prolongate, lattice_restrict

    return dict(
        restrict=lambda tr, r, level_c, level_f: lattice_restrict(
            r, (tr["Ix"], tr["Iy"], tr["Iz"]), level_f.shape),
        prolong=lambda tr, u, level_c, level_f: lattice_prolongate(
            u, (tr["Ix"], tr["Iy"], tr["Iz"]), level_c.shape),
        dot=lambda u, v, lv: inner_product(u, v),
        zeros=_zeros(flat),
    )


def _shifted(raw, sigma):
    """``x -> A x`` from a raw (bc-on-input-only) apply: adds the lumped-
    mass shift ``sigma * m3 * x`` (``m3`` bc-zeroed) when ``sigma`` is
    nonzero, then the Dirichlet identity rows."""

    def apply(lv, x, level):
        y = raw(lv, x, level)
        if sigma:
            y = y + sigma * lv["m3"] * x
        return torch.where(lv["bc_marker"], x, y)

    return apply


def default_cycle_ops(sigma=0.0):
    """V-cycle primitives of the dofmap backend: the gather / cell kernel /
    scatter apply (`ops.laplacian`) and the dofmap p-transfers
    (`ops.interpolate`); flat vectors."""
    from ..ops.interpolate import prolongate, restrict
    from ..ops.laplacian import laplacian_scatter_raw

    def raw(lv, x, level):
        return laplacian_scatter_raw(x, lv["dofmap"], lv["G"], lv["coeff"],
                                     lv["D"], lv["bc_marker"])

    return dict(
        apply=_shifted(raw, sigma),
        restrict=lambda tr, r, level_c, level_f: restrict(
            r, tr["dofmap_c"], tr["dofmap_f"], tr["M1"], tr["mult_f"],
            level_c.ndofs),
        prolong=lambda tr, u, level_c, level_f: prolongate(
            u, tr["dofmap_c"], tr["dofmap_f"], tr["M1"], level_f.ndofs),
        dot=lambda u, v, lv: inner_product(u, v),
        zeros=_zeros(True),
    )


def lattice_cycle_ops(sigma=0.0):
    """V-cycle primitives of the plain-torch lattice backend (general
    hexes, `ops.lattice`) with the lattice per-axis transfers; flat
    vectors."""
    from ..ops.lattice import lattice_laplacian_apply

    def raw(lv, x, level):
        mats = {k: lv[k] for k in ("Ex", "Dx", "Ey", "Dy", "Ez", "Dz")}
        return lattice_laplacian_apply(x, mats, lv["G"], lv["bc_marker"],
                                       apply_bc=False)

    return dict(apply=_shifted(raw, sigma), **_lattice_transfers(flat=True))


def lattice_blocked_cycle_ops(sigma=0.0):
    """V-cycle primitives whose general-hex applies run K-A of
    `ops.lattice_blocked` (the CUDA kernel on CUDA tensors, its plain torch
    version on CPU tensors); lattice per-axis transfers; flat vectors.
    A sigma shift rides a torch epilogue on the raw kernel output."""
    from ..ops.lattice_blocked import blocked_lattice_apply

    def apply_op(lv, x, level):
        nc = tuple((N - 1) // level.P for N in level.shape)
        if not sigma:
            return blocked_lattice_apply(x, lv["lb_mats"], lv["Gt"],
                                         lv["bc_marker"], nc, level.P)
        y = blocked_lattice_apply(x, lv["lb_mats"], lv["Gt"],
                                  lv["bc_marker"], nc, level.P,
                                  apply_bc=False)
        y = y + sigma * lv["m3"] * x
        return torch.where(lv["bc_marker"], x, y)

    return dict(apply=apply_op, **_lattice_transfers(flat=True))


def kron_cycle_ops(sigma=0.0):
    """V-cycle primitives backed by the plain-torch Kronecker-sum apply
    (`ops.kron`) and the lattice per-axis transfers; lattice-shaped
    vectors throughout."""
    from ..ops.kron import kron_laplacian_apply

    def apply_op(lv, x, level):
        return kron_laplacian_apply(
            x, (lv["Kx"], lv["Ky"], lv["Kz"]), (lv["mx"], lv["my"], lv["mz"]),
            lv["bc_marker"], sigma=sigma,
        )

    return dict(apply=apply_op, **_lattice_transfers())


def kron_blocked_cycle_ops(sigma=0.0):
    """V-cycle primitives whose operator applies run the blocked kernel
    pair (`ops.kron_blocked`): the CUDA kernels on CUDA tensors, their
    plain torch versions on CPU tensors. The down-sweep ``r = b - A u``
    runs through the fused residual kernel (the JAX package's default
    ``fuse_residual=True``). Transfers and dots are the same torch
    primitives as `kron_cycle_ops`."""
    from ..ops.kron_blocked import blocked_kron_apply, blocked_kron_residual

    def apply_op(lv, x, level):
        return blocked_kron_apply(x, lv["kb_mats"], sigma=sigma)

    def residual_op(lv, b, u, level):
        return blocked_kron_residual(b, u, lv["kb_mats"], sigma=sigma)

    return dict(apply=apply_op, residual=residual_op, **_lattice_transfers())


def v_cycle(data, b_in, u_in, *, levels, coarse="smoother", coarse_cfg=None,
            ops):
    """One V-cycle ``u_out = PMG(b_in, u_in)``.

    ``data`` holds the per-level arrays (``levels``), the inter-level
    transfer matrices (``transfer``) and the coarse-solver arrays;
    ``levels`` is the tuple of `Level`; ``ops`` the cycle primitives.
    """
    coarse_cfg = coarse_cfg or {}
    if coarse_cfg.get("gamma", 1) != 1:
        raise NotImplementedError(_CYCLE_TODO)
    L = len(levels)
    lvs = data["levels"]
    us = [None] * L
    bs = [None] * L
    us[L - 1] = u_in
    bs[L - 1] = b_in
    dot = ops["dot"]
    zeros = ops["zeros"]

    def smooth(lv, b, x, level):
        return chebyshev4_solve(
            lambda t: ops["apply"](lv, t, level), b, x,
            lv["diag_inv"], lv["lmax"], level.smoother_iters,
        )

    residual = ops.get(
        "residual",
        lambda lv, b, u, level: b - ops["apply"](lv, u, level),
    )

    # Down sweep: pre-smooth and restrict.
    for i in range(L - 1, 0, -1):
        if i < L - 1:
            us[i] = zeros(levels[i], b_in)
        us[i] = smooth(lvs[i], bs[i], us[i], levels[i])
        r = residual(lvs[i], bs[i], us[i], levels[i])
        bs[i - 1] = ops["restrict"](
            data["transfer"][i - 1], r, levels[i - 1], levels[i]
        )

    # Coarse level: mask Dirichlet rows of the restricted rhs, then solve.
    bc0 = lvs[0]["bc_marker"]
    b0 = torch.where(bc0, torch.zeros_like(bs[0]), bs[0])
    u0 = zeros(levels[0], b_in)
    if coarse == "smoother":
        u0 = smooth(lvs[0], b0, u0, levels[0])
    elif coarse == "cg":
        A0 = lambda x: ops["apply"](lvs[0], x, levels[0])
        u0, _ = cg_solve(
            A0, b0, u0, lvs[0]["diag_inv"],
            rtol=coarse_cfg.get("rtol", 1e-8),
            maxiter=coarse_cfg.get("maxiter", 60),
            dot=lambda u, v: dot(u, v, lvs[0]),
        )
    elif coarse == "fdm":
        from .fdm import fdm_solve

        fd = data["fdm"]
        u0 = fdm_solve(
            b0, (fd["Vx"], fd["Vy"], fd["Vz"]),
            (fd["Vxt"], fd["Vyt"], fd["Vzt"]), fd["dinv"],
            fd["bc_global"], coarse_cfg["fdm_shape"],
            trims=coarse_cfg.get("fdm_trims", ((1, 1),) * 3),
        )
    else:
        raise NotImplementedError(_COARSE_TODO)
    us[0] = u0

    # Up sweep: prolong, correct, post-smooth.
    for i in range(L - 1):
        du = ops["prolong"](data["transfer"][i], us[i], levels[i],
                            levels[i + 1])
        us[i + 1] = us[i + 1] + du
        us[i + 1] = smooth(lvs[i + 1], bs[i + 1], us[i + 1], levels[i + 1])
    return us[L - 1]


def _merge_state(dst, src, path):
    """Overwrite the arrays of ``dst`` that ``src`` also holds (recursing
    into nested dicts); keys only ``dst`` has stay."""
    for key, old in dst.items():
        if key not in src:
            continue
        new = src[key]
        if isinstance(old, dict):
            _merge_state(old, new, f"{path}.{key}")
        elif isinstance(old, torch.Tensor):
            if tuple(new.shape) != tuple(old.shape):
                raise ValueError(
                    f"{path}.{key}: shape {tuple(new.shape)} does not match "
                    f"{tuple(old.shape)}")
            dst[key] = new.to(device=old.device, dtype=old.dtype).contiguous()


class PMGHierarchy:
    """Build and run the p-multigrid stack on one device.

    Per-level operators and Jacobi diagonals, CG/Lanczos smoother
    calibration, transfer matrices and the composed V-cycle, with
    ``solve`` (stationary iteration) and ``solve_pcg`` (FCG(V)). The
    ``device`` is explicit; every array lives there.
    """

    def __init__(self, mesh, degrees=(1, 3), kappa=2.0, dtype=torch.float64,
                 smoother_iters=DEFAULT_SMOOTHER_ITERS, coarse="smoother",
                 coarse_cfg=None,
                 calibration_iters=DEFAULT_CALIBRATION_ITERS,
                 operator="dofmap", precision="highest", sigma=0.0,
                 smoother="cheb", *, device):
        """``operator`` is 'dofmap' (gather/scatter, any hex mesh),
        'lattice' (plain torch, any hex mesh), 'lattice_blocked' (the
        CUDA kernels on a CUDA device, any hex mesh, float32 only), 'kron'
        (plain torch, axis-aligned boxes) or 'kron_blocked' (the CUDA
        kernels, axis-aligned boxes, float32 only); ``coarse`` is
        'smoother', 'cg' or 'fdm' (axis-aligned only); ``kappa`` a scalar;
        ``sigma`` a scalar lumped-mass shift."""
        from ..fem.assembly import (
            geometry_factors_np,
            lumped_mass_np,
            ops_shift_scalar,
            resolve_kappa_axes,
            resolve_kappa_split,
            resolve_sigma,
            scale_G,
        )
        from ..fem.gll import derivative_matrix, interpolation_matrix_1d
        from ..fem.mesh import require_axis_aligned
        from ..ops.kron import (
            axis_stiffness_mass,
            kron_diagonal,
            robin_axis_ends,
        )
        from ..ops.laplacian import laplacian_diagonal
        from ..ops.lattice import (
            axis_interpolation_matrix,
            geometry_to_qlattice,
            lattice_mats,
        )

        if operator in ("csr", "dss"):
            raise NotImplementedError(_OPERATOR_TODO)
        if operator not in _OPERATORS:
            raise ValueError(
                f"unknown operator backend {operator!r}; expected one of "
                f"{_OPERATORS}")
        if coarse not in ("smoother", "cg", "fdm"):
            raise NotImplementedError(_COARSE_TODO)
        if smoother != "cheb":
            raise NotImplementedError(
                "only the point-Jacobi Chebyshev smoother is ported; "
                "'line' and 'schwarz' are ROADMAP.md Queue 1 item 7")
        if (coarse_cfg or {}).get("gamma", 1) != 1:
            raise NotImplementedError(_CYCLE_TODO)
        if precision != "highest":
            raise NotImplementedError(
                "only precision='highest' (true f32/f64) is ported; "
                "'high' (bf16x3) is ROADMAP.md Queue 1 item 1")
        kron_family = operator in ("kron", "kron_blocked")
        self.sigma, sigma_field = resolve_sigma(sigma)
        if sigma_field is not None:
            if kron_family:
                raise ValueError(
                    "a sigma FIELD (callable) requires a general backend; "
                    "the Kronecker paths carry only a separable scalar shift"
                )
            raise NotImplementedError(_SIGMA_FIELD_TODO)
        if (not any(any(f) for f in mesh.dirichlet_faces)
                and self.sigma == 0.0):
            raise ValueError(
                "pure-Neumann problem (no Dirichlet face) with sigma=0 is "
                "singular (constant nullspace); add a Dirichlet face or a "
                "positive sigma shift"
            )
        if kron_family:
            require_axis_aligned(mesh, f"operator='{operator}'")
        if coarse == "fdm":
            require_axis_aligned(mesh, "coarse='fdm'")
        if (operator in ("kron_blocked", "lattice_blocked")
                and dtype != torch.float32):
            raise ValueError(
                f"operator='{operator}' is f32-only (CUDA kernels); "
                f"got dtype={dtype}"
            )
        self.mesh = mesh
        self.degrees = tuple(int(p) for p in degrees)
        self.device = torch.device(device)
        kc, kt, const = resolve_kappa_split(mesh, kappa)
        self.kappa = float(kc[0]) if const else None
        self.kappa_axes = resolve_kappa_axes(mesh, kappa,
                                             split=(kc, kt, const))
        self.dtype = dtype
        self.coarse = coarse
        self.coarse_cfg = dict(coarse_cfg or {})
        self.operator_kind = operator
        self.eigs = []
        ops_sigma = ops_shift_scalar(mesh, self.sigma, kron_family)
        if operator == "kron":
            self._ops = kron_cycle_ops(sigma=self.sigma)
        elif operator == "kron_blocked":
            self._ops = kron_blocked_cycle_ops(sigma=self.sigma)
        elif operator == "lattice":
            self._ops = lattice_cycle_ops(sigma=ops_sigma)
        elif operator == "lattice_blocked":
            self._ops = lattice_blocked_cycle_ops(sigma=ops_sigma)
        else:
            self._ops = default_cycle_ops(sigma=ops_sigma)
        ops = self._ops
        tensor = lambda a: torch.tensor(a, dtype=dtype, device=self.device)
        dofmap_t = lambda P: torch.tensor(mesh.dofmap(P), dtype=torch.int64,
                                          device=self.device)

        level_data = []
        levels = []
        for P in self.degrees:
            shape = mesh.lattice_shape(P)
            ndofs = mesh.num_dofs(P)
            bc_np = mesh.boundary_dof_marker(P)
            bc = torch.tensor(bc_np, device=self.device)
            level = Level(P=P, ndofs=ndofs, smoother_iters=smoother_iters,
                          shape=None if operator == "dofmap" else shape)
            if kron_family:
                bc = bc.reshape(shape)
                lv = {}
                for a, (name, nc_a, h_a, k_a) in enumerate(
                        zip("xyz", mesh.nc, mesh.h_cells, self.kappa_axes)):
                    K, m = axis_stiffness_mass(
                        nc_a, P, h_a,
                        robin=robin_axis_ends(mesh, a, 1.0 / k_a))
                    lv["K" + name] = tensor(k_a * K)
                    lv["m" + name] = tensor(m)
                lv["bc_marker"] = bc
                diag = kron_diagonal(
                    (lv["Kx"], lv["Ky"], lv["Kz"]),
                    (lv["mx"], lv["my"], lv["mz"]),
                    bc, sigma=self.sigma,
                ).reshape(shape)
                if operator == "kron_blocked":
                    # The kernels consume the symmetrized form with
                    # separable bc masks; the raw 1D factors are not
                    # needed at runtime.
                    from ..ops.kron_blocked import (
                        checked_face_masks,
                        symmetrized_mats,
                    )

                    lv["kb_mats"] = symmetrized_mats(
                        (lv["Kx"], lv["Ky"], lv["Kz"]),
                        (lv["mx"], lv["my"], lv["mz"]),
                        checked_face_masks(mesh, P, bc_np),
                        band=P, device=self.device, dtype=dtype,
                    )
                    for name in "xyz":
                        del lv["K" + name], lv["m" + name]
            else:
                # General family: geometry factors in float64 on the host
                # (shared with the rhs and the error norm), cast once.
                G_cells, _ = geometry_factors_np(mesh, P, kappa=kt)
                if operator == "lattice":
                    lv = lattice_mats(mesh.nc, P, dtype, self.device)
                    lv["G"] = tensor(geometry_to_qlattice(
                        scale_G(G_cells, kc, kt), mesh.nc, P))
                elif operator == "lattice_blocked":
                    from ..ops.lattice_blocked import (
                        geometry_to_gfirst,
                        lattice_blocked_mats,
                    )

                    lv = dict(
                        Gt=tensor(geometry_to_gfirst(geometry_to_qlattice(
                            scale_G(G_cells, kc, kt), mesh.nc, P))),
                        lb_mats=lattice_blocked_mats(
                            mesh.nc, P, dtype, device=self.device),
                    )
                else:
                    lv = dict(dofmap=dofmap_t(P), G=tensor(G_cells),
                              coeff=tensor(kc),
                              D=tensor(derivative_matrix(P)))
                lv["bc_marker"] = bc
                # The exact diagonal through the dofmap formulation.
                diag = laplacian_diagonal(
                    lv["dofmap"] if "dofmap" in lv else dofmap_t(P),
                    lv["G"] if operator == "dofmap" else tensor(G_cells),
                    tensor(kc), tensor(derivative_matrix(P)), bc, ndofs)
                if ops_sigma:
                    # Lumped-mass shift, bc-zeroed, added pointwise in the
                    # apply and to the Jacobi diagonal.
                    lv["m3"] = tensor(lumped_mass_np(mesh, P, bc_zero=True))
                    diag = diag + ops_sigma * lv["m3"]
            lv["diag_inv"] = 1.0 / diag
            vshape = shape if kron_family else (ndofs,)
            # Smoother calibration: 20 recorded CG iterations on A x = 1,
            # Lanczos estimate, lmax inflated by 1.1.
            _, info = _generic_calibration(
                lv, torch.ones(vshape, dtype=dtype, device=self.device),
                torch.zeros(vshape, dtype=dtype, device=self.device),
                ops=ops, level=level, maxiter=calibration_iters,
            )
            eigs = lanczos_eigenvalue_estimates(
                info["alphas"].cpu().numpy(), info["betas"].cpu().numpy(),
                info["stored"].cpu().numpy(),
            )
            self.eigs.append(eigs)
            lv["lmax"] = tensor(EIG_RANGE_FACTORS[1] * eigs[-1])
            level_data.append(lv)
            levels.append(level)

        transfer = []
        for i in range(len(self.degrees) - 1):
            Pc, Pf = self.degrees[i], self.degrees[i + 1]
            if operator == "dofmap":
                transfer.append(dict(
                    M1=tensor(interpolation_matrix_1d(Pc, Pf)),
                    dofmap_c=dofmap_t(Pc), dofmap_f=dofmap_t(Pf),
                    mult_f=tensor(mesh.dof_multiplicity(Pf)),
                ))
            else:
                transfer.append({
                    "I" + name: tensor(axis_interpolation_matrix(nc_a, Pc, Pf))
                    for name, nc_a in zip("xyz", mesh.nc)
                })

        self.data = dict(levels=level_data, transfer=transfer)
        self.levels = tuple(levels)

        if coarse == "fdm":
            from .fdm import FastDiagonalizationSolver

            fd = FastDiagonalizationSolver(
                mesh, self.degrees[0], kappa=self.kappa_axes[0],
                dtype=dtype, sigma=self.sigma, device=self.device,
            )
            self.data["fdm"] = dict(
                Vx=fd.Vs[0], Vy=fd.Vs[1], Vz=fd.Vs[2],
                Vxt=fd.Vts[0], Vyt=fd.Vts[1], Vzt=fd.Vts[2],
                dinv=fd.dinv, bc_global=fd.bc_marker,
            )
            self.coarse_cfg["fdm_shape"] = mesh.lattice_shape(self.degrees[0])
            self.coarse_cfg["fdm_trims"] = fd.trims

    def load_state(self, data):
        """Overwrite this hierarchy's level, transfer and coarse arrays
        (calibrated ``lmax`` included) with those in ``data`` — a dict of
        the same layout, e.g. from `utils.convert.hierarchy_data_from_numpy`
        — so two implementations can run cycles on identical state. Keys
        ``data`` does not hold keep their values; shapes must match."""
        for i, lv in enumerate(data["levels"]):
            _merge_state(self.data["levels"][i], lv, f"levels[{i}]")
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

    def _to_work(self, v):
        v = torch.as_tensor(v, dtype=self.dtype, device=self.device)
        if self.operator_kind in ("kron", "kron_blocked"):
            return v.reshape(self.levels[-1].shape)
        return v.reshape(-1)

    def apply(self, b, u):
        """One V-cycle from iterate ``u`` (flat vectors)."""
        return self._vcycle(self._to_work(b), self._to_work(u)).reshape(-1)

    def solve(self, b, num_cycles=10, u0=None, residuals=True, fmg=False):
        """Stationary V-cycle iteration. Returns ``(u, residual_norms)``.

        The residual norms stay on the device and are read back once, at
        the end."""
        if fmg:
            raise NotImplementedError(_CYCLE_TODO)
        b = self._to_work(b)
        u = torch.zeros_like(b) if u0 is None else self._to_work(u0)
        lv_f = self.data["levels"][-1]
        norms = []
        for _ in range(num_cycles):
            u = self._vcycle(b, u)
            r = b - self._fine_apply(u)
            norms.append(torch.sqrt(self._ops["dot"](r, r, lv_f)))
        u = u.reshape(-1)
        if not residuals or not norms:
            return u, []
        return u, [float(v) for v in torch.stack(norms).cpu().numpy()]

    def solve_pcg(self, b, rtol=1e-8, maxiter=50, fmg=False):
        """V-cycle-preconditioned flexible CG. Returns ``(u, niter)``.

        The loop reads its convergence flag on the host once per
        iteration (a CUDA graph or a fixed-count loop would remove that
        sync; later work)."""
        from .cg import fcg_solve

        if fmg:
            raise NotImplementedError(_CYCLE_TODO)
        lv_f = self.data["levels"][-1]
        b = self._to_work(b)
        u, info = fcg_solve(
            self._fine_apply, b, torch.zeros_like(b),
            lambda r: self._vcycle(r, torch.zeros_like(r)),
            rtol=float(rtol), maxiter=int(maxiter),
            dot=lambda u_, v_: self._ops["dot"](u_, v_, lv_f),
        )
        return u.reshape(-1), int(info["niter"])

    def solve_refined(self, *args, **kwargs):
        raise NotImplementedError(
            "solve_refined (f64 outer residual) is ROADMAP.md Queue 1 "
            "item 4")
