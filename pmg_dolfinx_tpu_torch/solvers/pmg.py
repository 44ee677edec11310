"""The p-multigrid V-cycle preconditioner.

Port of `pmg_dolfinx_tpu.solvers.pmg`: the operator backends
``"dofmap"`` (gather / cell kernel / scatter, `ops/laplacian.py`; the
default), ``"lattice"`` (general hexes, plain torch einsums),
``"lattice_blocked"`` (general hexes, the CUDA kernels of
`ops/lattice_blocked.py`), ``"kron"`` and ``"kron_blocked"`` (axis-aligned
boxes, plain torch / the CUDA kernels of `ops/kron_blocked.py`); the
V-cycle with a ``"smoother"``, ``"cg"``, ``"fdm"``, ``"direct"`` (dense
Cholesky) or ``"hmg"`` (nested geometric h-multigrid, `solvers/hmg.py`)
coarse solve; the point-Jacobi, line (`solvers/line.py`) and cell-wise
Schwarz (`solvers/schwarz.py`) Chebyshev smoothers; CG + Lanczos
smoother calibration on the preconditioned operator, the W-cycle
(``coarse_cfg["gamma"]``),
the full-multigrid initial guess (`fmg_initial_guess`), the fused
Chebyshev smoother and the fused p-transfers of ``kron_blocked``
(``fuse_smoother=True``, ``fuse_transfers=True``), and the
stationary (`solve`), FCG (`solve_pcg`), batched (`solve_many`,
`solve_pcg_many`) and f64-refined (`solve_refined`) outer iterations;
every coefficient `fem.assembly.resolve_kappa` takes (per-axis and
diagonal-tensor kappa on the Kronecker family, variable and full-tensor
kappa on the general family), sigma fields (general family), and the
mesh's Robin faces, Neumann faces and graded spacing. The
Kronecker family keeps vectors
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

import dataclasses
from dataclasses import dataclass

import numpy as np
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
_COARSE = ("smoother", "cg", "fdm", "direct", "hmg")
_COARSE_TODO = ("coarse='amg' (smoothed-aggregation AMG) is not ported yet "
                "(ROADMAP.md Queue 1 item 8)")


@dataclass(frozen=True)
class Level:
    """Static metadata for one p-level (arrays live in the data dict)."""

    P: int
    ndofs: int
    smoother_iters: int = DEFAULT_SMOOTHER_ITERS
    shape: tuple | None = None
    # The unstructured layout's static sizes: None until the DSS backend
    # is ported (ROADMAP.md Queue 1 item 8).
    dss: object = None
    # Line-relaxation axis when the level's data carries "line_inv".
    line_axis: int = 2


def _level_precond(lv, level, ops):
    """The level's smoother preconditioner ``r -> M^-1 r`` when it carries
    line blocks (``line_inv``) or Schwarz data (``schwarz``, its partials
    reconciled by ``ops["exchange"]`` on a device grid); None for point
    Jacobi."""
    if level.dss is not None:
        raise NotImplementedError(
            "the DSS Schwarz smoother is ROADMAP.md Queue 1 item 8")
    if "line_inv" in lv:
        from .line import line_precond_apply

        return lambda r: line_precond_apply(lv["line_inv"], r, level.shape,
                                            level.line_axis)
    if "schwarz" in lv:
        from .schwarz import schwarz_precond_apply

        return lambda r: schwarz_precond_apply(
            lv["schwarz"], r, level.shape, level.P,
            exchange=ops.get("exchange"))
    return None


def warn_tensor_stationary(kappa_fold, kappa_axes=None, operator="",
                           line=False):
    """Warn that the stationary V-cycle iteration can diverge with a
    strongly anisotropic tensor kappa (measured in the JAX package:
    rotated 100:1 anisotropy, levels (1, 3, 6), the default 2 Chebyshev
    iterations diverge while FCG(V) converges in 10). The remedies:
    `solve_pcg`, 3-4 ``smoother_iters``, or ``smoother='line'`` at
    moderate sizes. Diagonal tensors on the Kronecker family and
    hierarchies already running a line or Schwarz smoother (``line``)
    are exempt."""
    if line:
        return
    if kappa_axes is not None and operator in ("kron", "kron_blocked"):
        return
    if kappa_fold is not None:
        import warnings

        warnings.warn(
            "stationary V-cycle iteration with a tensor (anisotropic) "
            "kappa can diverge for strong off-axis anisotropy; prefer "
            "solve_pcg, which is robust (measured: rotated 100:1 "
            "anisotropy, FCG(V) 10 iterations), or raise "
            "smoother_iters (3-4 measured to restore stationary "
            "contraction, threshold problem-dependent) or use "
            "smoother='line' at moderate sizes; a better coarse "
            "operator does not help — the divergence lives at the "
            "high-p smoothing levels",
            stacklevel=3,
        )


def dense_cholesky(mesh, P, kappa, sigma=0.0, sigma_field=None):
    """The ``direct`` coarse factor: the lower Cholesky factor (host numpy,
    float64) of the dense bc-applied stiffness plus the lumped-mass
    ``sigma`` shift. Dense: for moderate coarse sizes only."""
    from ..fem.assembly import assemble_stiffness, shifted_mass_np

    A0 = assemble_stiffness(mesh, P, kappa=kappa).toarray()
    if sigma:
        A0[np.diag_indices_from(A0)] += sigma * shifted_mass_np(
            mesh, P, sigma_field)
    return np.linalg.cholesky(A0)


def _generic_calibration(lv, b, x0, *, ops, level, maxiter):
    # lmax of the SAME preconditioned operator the smoother iterates on
    A = lambda x: ops["apply"](lv, x, level)
    return cg_solve(
        A, b, x0, lv["diag_inv"],
        rtol=DEFAULT_CALIBRATION_RTOL, maxiter=maxiter, record=True,
        dot=lambda u, v: ops["dot"](u, v, lv),
        precond=_level_precond(lv, level, ops),
    )


def _zeros(flat):
    """The ``zeros`` cycle primitive: flat ``(ndofs,)`` vectors for the
    general family, lattice-shaped ones for the Kronecker family."""
    return lambda level, like: torch.zeros(
        level.ndofs if flat else level.shape, dtype=like.dtype,
        device=like.device)


def _lattice_transfers(flat=False, precision="highest"):
    from ..ops.lattice import lattice_prolongate, lattice_restrict

    return dict(
        restrict=lambda tr, r, level_c, level_f: lattice_restrict(
            r, (tr["Ix"], tr["Iy"], tr["Iz"]), level_f.shape, precision),
        prolong=lambda tr, u, level_c, level_f: lattice_prolongate(
            u, (tr["Ix"], tr["Iy"], tr["Iz"]), level_c.shape, precision),
        dot=lambda u, v, lv: inner_product(u, v),
        zeros=_zeros(flat),
    )


def _fused_transfers():
    """``restrict``/``prolong`` through `ops.transfer.blocked_transfer`
    (kernels #10/#11 on CUDA tensors). Each transfer's ``(Mx, My, MzT)``
    (and with them the nonzero ranges the kernels cache on the matrices)
    is formed once per transfer dict and direction, and again only when
    `PMGHierarchy.load_state` replaces the interpolation matrices."""
    from ..ops.transfer import blocked_transfer, transfer_mats

    plans = {}

    def mats(tr, direction):
        I1s = (tr["Ix"], tr["Iy"], tr["Iz"])
        key = (id(tr), direction)
        hit = plans.get(key)
        # the plan holds I1s, so an identity match cannot be a reused id
        if hit is None or any(a is not b for a, b in zip(hit[0], I1s)):
            hit = plans[key] = (I1s, transfer_mats(I1s, direction,
                                                   dtype=I1s[0].dtype))
        return hit[1]

    return dict(
        restrict=lambda tr, r, level_c, level_f: blocked_transfer(
            r, *mats(tr, "restrict")),
        prolong=lambda tr, u, level_c, level_f: blocked_transfer(
            u, *mats(tr, "prolong")),
    )


def _tpu_tile(name, value, default):
    """The JAX factories' TPU tile knobs keep their positions; the CUDA
    kernels fix their own tiles, so anything but JAX's default raises."""
    from ..ops.kron_blocked import _tpu_knob

    _tpu_knob(name, value, default)


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


def lattice_cycle_ops(precision="highest", sigma=0.0):
    """V-cycle primitives of the plain-torch lattice backend (general
    hexes, `ops.lattice`) with the lattice per-axis transfers; flat
    vectors. ``precision`` as in the JAX package ('highest' only)."""
    from ..ops.kron_blocked import _check_precision
    from ..ops.lattice import lattice_laplacian_apply

    _check_precision(precision)

    def raw(lv, x, level):
        mats = {k: lv[k] for k in ("Ex", "Dx", "Ey", "Dy", "Ez", "Dz")}
        return lattice_laplacian_apply(x, mats, lv["G"], lv["bc_marker"],
                                       apply_bc=False)

    return dict(apply=_shifted(raw, sigma),
                **_lattice_transfers(flat=True, precision=precision))


def lattice_blocked_cycle_ops(precision="highest", bcells=1, sigma=0.0):
    """V-cycle primitives whose general-hex applies run K-A of
    `ops.lattice_blocked` (the CUDA kernel on CUDA tensors, its plain torch
    version on CPU tensors); lattice per-axis transfers; flat vectors.
    A sigma shift rides a torch epilogue on the raw kernel output.
    ``bcells`` is the JAX kernel's TPU tile knob: only its default 1."""
    from ..ops.kron_blocked import _check_precision
    from ..ops.lattice_blocked import blocked_lattice_apply

    _check_precision(precision)
    _tpu_tile("bcells", bcells, 1)

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

    # transfers are cheap; keep them exact (as the JAX package does)
    return dict(apply=apply_op, **_lattice_transfers(flat=True))


def kron_cycle_ops(precision="highest", sigma=0.0):
    """V-cycle primitives backed by the plain-torch Kronecker-sum apply
    (`ops.kron`) and the lattice per-axis transfers; lattice-shaped
    vectors throughout. ``precision`` as in the JAX package ('highest'
    only)."""
    from ..ops.kron import kron_laplacian_apply
    from ..ops.kron_blocked import _check_precision

    _check_precision(precision)

    def apply_op(lv, x, level):
        return kron_laplacian_apply(
            x, (lv["Kx"], lv["Ky"], lv["Kz"]), (lv["mx"], lv["my"], lv["mz"]),
            lv["bc_marker"], sigma=sigma,
        )

    return dict(apply=apply_op, **_lattice_transfers(precision=precision))


def kron_blocked_cycle_ops(precision="highest", by=None, bx=None,
                           fuse_smoother=False, sigma=0.0,
                           fuse_residual=True, fuse_transfers=False):
    """V-cycle primitives whose operator applies run the blocked kernel
    pair (`ops.kron_blocked`): the CUDA kernels on CUDA tensors, their
    plain torch versions on CPU tensors. The down-sweep ``r = b - A u``
    runs through the fused residual kernel (``fuse_residual``, the JAX
    package's default). ``fuse_smoother=True`` makes the smoother
    `blocked_kron_cheb4`: each Chebyshev half-step is the full-bc kernel
    #4 then kernel #7, which folds the update into the operator's
    epilogue. ``fuse_transfers=True`` runs the p-transfers through
    `ops.transfer.blocked_transfer` (kernels #10/#11); otherwise they are
    the torch einsums of `kron_cycle_ops`. The parameters keep the JAX
    package's order; ``by``/``bx`` are its TPU slab sizes and must stay
    None."""
    from ..ops.kron_blocked import (
        _check_precision,
        blocked_kron_apply,
        blocked_kron_cheb4,
        blocked_kron_residual,
    )

    _check_precision(precision)
    _tpu_tile("by", by, None)
    _tpu_tile("bx", bx, None)

    def apply_op(lv, x, level):
        return blocked_kron_apply(x, lv["bc_marker"], lv["kb_mats"],
                                  sigma=sigma)

    def smooth_op(lv, b, x, level):
        return blocked_kron_cheb4(b, x, lv["bc_marker"], lv["kb_mats"],
                                  lv["diag_inv"], lv["lmax"],
                                  level.smoother_iters, sigma=sigma)

    def residual_op(lv, b, u, level):
        return blocked_kron_residual(b, u, lv["bc_marker"], lv["kb_mats"],
                                     sigma=sigma)

    fused = {}
    if fuse_smoother:
        fused = dict(smooth=smooth_op, residual=residual_op)
    elif fuse_residual:
        fused = dict(residual=residual_op)
    # transfers are cheap; keep them exact (as the JAX package does)
    transfers = _lattice_transfers()
    if fuse_transfers:
        transfers.update(_fused_transfers())
    return dict(apply=apply_op, **fused, **transfers)


def v_cycle(data, b_in, u_in, *, levels, coarse="smoother", coarse_cfg=None,
            ops):
    """One V-cycle ``u_out = PMG(b_in, u_in)``.

    ``data`` holds the per-level arrays (``levels``), the inter-level
    transfer matrices (``transfer``) and the coarse-solver arrays;
    ``levels`` is the tuple of `Level`; ``ops`` the cycle primitives
    (``ops["smooth"]``, where a backend fuses the smoother, replaces the
    generic Chebyshev-4, whose preconditioner is the level's line blocks,
    Schwarz data or Jacobi diagonal). ``coarse_cfg["gamma"]`` selects the
    cycle index: 1 = V-cycle (default), 2 = W-cycle; ``coarse="hmg"``
    reads its nested hierarchy from ``coarse_cfg`` (``hmg_levels``,
    ``hmg_ops``, ``hmg_bottom``, ``hmg_gamma``, ``cycles``: 2 unless set,
    `PMGHierarchy` sets 3) and ``data["hmg"]``.
    """
    coarse_cfg = coarse_cfg or {}
    L = len(levels)
    lvs = data["levels"]
    us = [None] * L
    bs = [None] * L
    us[L - 1] = u_in
    bs[L - 1] = b_in
    dot = ops["dot"]
    zeros = ops["zeros"]

    def _default_smooth(lv, b, x, level):
        minv = _level_precond(lv, level, ops)
        return chebyshev4_solve(
            lambda t: ops["apply"](lv, t, level), b, x,
            lv["diag_inv"] if minv is None else minv, lv["lmax"],
            level.smoother_iters,
        )

    smooth = ops.get("smooth", _default_smooth)
    residual = ops.get(
        "residual",
        lambda lv, b, u, level: b - ops["apply"](lv, u, level),
    )

    # W-cycle (gamma > 1): visit the coarse sub-hierarchy ``gamma`` times
    # per level; the recursion bottoms out at the two-level cycle.
    gamma = coarse_cfg.get("gamma", 1)
    if gamma > 1 and L > 2:
        top = L - 1
        u = smooth(lvs[top], b_in, u_in, levels[top])
        r = residual(lvs[top], b_in, u, levels[top])
        b_c = ops["restrict"](
            data["transfer"][top - 1], r, levels[top - 1], levels[top]
        )
        sub = dict(data, levels=lvs[:top], transfer=data["transfer"][:top - 1])
        u_c = zeros(levels[top - 1], b_in)
        for _ in range(gamma):
            u_c = v_cycle(sub, b_c, u_c, levels=levels[:top], coarse=coarse,
                          coarse_cfg=coarse_cfg, ops=ops)
        du = ops["prolong"](
            data["transfer"][top - 1], u_c, levels[top - 1], levels[top]
        )
        return smooth(lvs[top], b_in, u + du, levels[top])

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
    # The direct, fdm and hmg solves work on the GLOBAL coarse problem: a
    # device-grid backend supplies "coarse_gather" / "coarse_slice"
    # (identities on one device).
    gather = ops.get("coarse_gather", lambda v: v)
    unslice = ops.get("coarse_slice", lambda v: v)
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
        u0 = unslice(fdm_solve(
            gather(b0), (fd["Vx"], fd["Vy"], fd["Vz"]),
            (fd["Vxt"], fd["Vyt"], fd["Vzt"]), fd["dinv"],
            fd["bc_global"], coarse_cfg["fdm_shape"],
            trims=coarse_cfg.get("fdm_trims", ((1, 1),) * 3),
        ))
    elif coarse == "direct":
        # Dense Cholesky factor from setup; the triangular solves take the
        # coarse vector flat (the coarse level is small).
        chol = data["coarse_chol"]
        b0g = gather(b0)
        y = torch.linalg.solve_triangular(chol, b0g.reshape(-1, 1),
                                          upper=False)
        u0g = torch.linalg.solve_triangular(chol.T, y, upper=True)
        u0 = unslice(u0g.reshape(b0g.shape))
    elif coarse == "hmg":
        # Nested geometric h-multigrid V-cycles (solvers/hmg.py): this
        # same function over the h-hierarchy, the rhs reshaped at the seam
        # to the h-levels' layout (lattice-shaped kron, flat lattice).
        hmg_ops = coarse_cfg.get("hmg_ops", ops)
        hmg_levels = coarse_cfg["hmg_levels"]
        u0g = hmg_ops["zeros"](hmg_levels[-1], b_in)
        b0g_raw = gather(b0)
        b0g = b0g_raw.reshape(u0g.shape)
        for _ in range(coarse_cfg.get("cycles", 2)):
            u0g = v_cycle(
                data["hmg"], b0g, u0g, levels=hmg_levels,
                coarse=coarse_cfg.get("hmg_bottom", "direct"),
                coarse_cfg={"gamma": coarse_cfg.get("hmg_gamma", 1)},
                ops=hmg_ops,
            )
        u0 = unslice(u0g.reshape(b0g_raw.shape))
    elif coarse == "amg":
        raise NotImplementedError(_COARSE_TODO)
    else:
        raise ValueError(f"unknown coarse solver '{coarse}'")
    us[0] = u0

    # Up sweep: prolong, correct, post-smooth.
    for i in range(L - 1):
        du = ops["prolong"](data["transfer"][i], us[i], levels[i],
                            levels[i + 1])
        us[i + 1] = us[i + 1] + du
        us[i + 1] = smooth(lvs[i + 1], bs[i + 1], us[i + 1], levels[i + 1])
    return us[L - 1]


def fmg_initial_guess(data, b_in, *, levels, coarse="smoother",
                      coarse_cfg=None, ops):
    """Full-multigrid (nested-iteration) initial guess: restrict the rhs
    down the p-hierarchy (Dirichlet rows of each restricted rhs masked to
    zero), then from the coarsest level up prolong the current solution
    and run one V-cycle of the truncated hierarchy (coarsest..i); at
    i = 0 that cycle is the coarse solve."""
    L = len(levels)
    lvs = data["levels"]
    bs = [None] * L
    bs[L - 1] = b_in
    for i in range(L - 1, 0, -1):
        r = ops["restrict"](data["transfer"][i - 1], bs[i],
                            levels[i - 1], levels[i])
        bs[i - 1] = torch.where(lvs[i - 1]["bc_marker"],
                                torch.zeros_like(r), r)
    u = None
    for i in range(L):
        if i:
            u = ops["prolong"](data["transfer"][i - 1], u,
                               levels[i - 1], levels[i])
        else:
            u = ops["zeros"](levels[0], b_in)
        data_i = dict(data, levels=lvs[: i + 1],
                      transfer=data["transfer"][:i])
        u = v_cycle(data_i, bs[i], u, levels=levels[: i + 1],
                    coarse=coarse, coarse_cfg=coarse_cfg, ops=ops)
    return u


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
                 fuse_smoother=False, fuse_transfers=False,
                 smoother="cheb", *, device):
        """``operator`` is 'dofmap' (gather/scatter, any hex mesh),
        'lattice' (plain torch, any hex mesh), 'lattice_blocked' (the
        CUDA kernels on a CUDA device, any hex mesh, float32 only), 'kron'
        (plain torch, axis-aligned boxes) or 'kron_blocked' (the CUDA
        kernels, axis-aligned boxes, float32 only); ``coarse`` is
        'smoother', 'cg', 'fdm' (axis-aligned only), 'direct' (dense
        Cholesky of the assembled p=1 matrix, moderate sizes) or 'hmg'
        (nested h-multigrid cycles: `solvers.hmg.build_hmg` on boxes,
        `build_hmg_general` on curved meshes; ``coarse_cfg`` keys
        ``sizes``, ``smoother``, ``bottom``, ``min_cells``, ``cycles``
        (default 3), ``hmg_gamma``). ``kappa`` is a scalar, a per-axis
        tuple, a DG-0 ``(ncells,)`` array, a symmetric ``(3, 3)`` or
        ``(ncells, 3, 3)`` tensor (folded into the geometry factors) or a
        callable sampled at the cell centroids; the Kronecker backends and
        'fdm' take the constant diagonal ones only. ``sigma`` is a scalar
        lumped-mass shift or a callable reaction field (general backends,
        baked into each level's ``m3``). Robin faces of the mesh ride the
        1D factors' ends (Kronecker family) or ``m3`` (general family).
        ``smoother`` is 'cheb' (point Jacobi),
        'line' / 'line-x|y|z' (line relaxation, moderate sizes) or
        'schwarz' (cell-wise FDM Schwarz, any size). ``fuse_smoother=True``
        (kron_blocked, point Jacobi only) runs the smoother through the
        fused Chebyshev kernel; ``fuse_transfers=True`` (kron_blocked
        only) runs the p-transfers through the transfer kernels #10/#11
        (`ops.transfer`). ``coarse_cfg["gamma"] = 2`` makes every cycle a
        W-cycle."""
        from ..fem.assembly import (
            geometry_factors_np,
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

        if (fuse_smoother or fuse_transfers) and operator != "kron_blocked":
            raise ValueError(
                "fuse_smoother/fuse_transfers require operator="
                "'kron_blocked' (kernel epilogues/transfers)"
            )
        if operator in ("csr", "dss"):
            raise NotImplementedError(_OPERATOR_TODO)
        if operator not in _OPERATORS:
            raise ValueError(
                f"unknown operator backend {operator!r}; expected one of "
                f"{_OPERATORS}")
        if coarse == "amg":
            raise NotImplementedError(_COARSE_TODO)
        if coarse not in _COARSE:
            raise ValueError(f"unknown coarse solver '{coarse}'")
        if precision != "highest":
            raise NotImplementedError(
                "only precision='highest' (true f32/f64) is ported; "
                "'high' (bf16x3) is ROADMAP.md Queue 1 item 1")
        kron_family = operator in ("kron", "kron_blocked")
        self.sigma, sigma_field = resolve_sigma(sigma)
        if sigma_field is not None:
            if kron_family:
                raise ValueError(
                    "a sigma FIELD (callable) requires a general backend "
                    "('lattice', 'lattice_blocked', 'dofmap') — the "
                    "Kronecker paths carry only a separable scalar shift"
                )
            if coarse == "fdm":
                raise ValueError(
                    "coarse='fdm' supports a scalar sigma only (the "
                    "shift must stay a pure eigenvalue offset); use "
                    "'hmg', 'cg', 'direct' or 'smoother'"
                )
            if smoother != "cheb" or (coarse_cfg or {}).get(
                    "smoother", "cheb") != "cheb":
                raise ValueError(
                    "line/schwarz smoothers support a scalar sigma only "
                    "(their block builders fold a uniform shift); use "
                    "smoother='cheb' with a sigma field"
                )
        self._sigma_field = sigma_field
        if (not any(any(f) for f in mesh.dirichlet_faces)
                and self.sigma == 0.0 and not mesh.has_robin):
            raise ValueError(
                "pure-Neumann problem (no Dirichlet face) with sigma=0 is "
                "singular (constant nullspace); add a Dirichlet face, a "
                "positive sigma shift, or a Robin face"
            )
        # The smoother's preconditioner on every p-level: point Jacobi
        # ('cheb'), line relaxation along the strongly-coupled axis
        # ('line' auto, 'line-x|y|z') or the cell-wise Schwarz blocks.
        from .line import line_block_inverses, parse_line_smoother

        self._schwarz = smoother == "schwarz"
        self._line_axis = (None if self._schwarz
                           else parse_line_smoother(smoother, mesh, kappa))
        if (self._line_axis is not None or self._schwarz) and fuse_smoother:
            raise ValueError(
                f"smoother={smoother!r} is incompatible with "
                "fuse_smoother=True (the fused kernel epilogue hard-codes "
                "point Jacobi)"
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
        self._kc, self._kappa_fold = kc, kt
        # the per-cell coefficient: the tensor when there is one
        self.kappa_cells = kt if kt is not None else kc
        self.kappa = float(kc[0]) if const else None
        self._kappa_raw = kappa
        # (kx, ky, kz) of a constant scalar, per-axis or diagonal-tensor
        # kappa (the Kronecker family and 'fdm' need it); None otherwise
        try:
            self.kappa_axes = resolve_kappa_axes(mesh, kappa,
                                                 split=(kc, kt, const))
        except ValueError:
            if kron_family:
                raise
            self.kappa_axes = None
        if self.kappa_axes is None and coarse == "fdm":
            raise ValueError(
                "coarse='fdm' is constant-coefficient (scalar, per-axis "
                "or diagonal-tensor) only; use 'hmg', 'cg', 'smoother' "
                "or 'direct' with variable kappa (or FDM as an outer FCG "
                "preconditioner, solvers/fdm.py)"
            )
        self.dtype = dtype
        self.coarse = coarse
        self.coarse_cfg = dict(coarse_cfg or {})
        self.operator_kind = operator
        self.eigs = []
        ops_sigma = ops_shift_scalar(mesh, self.sigma, kron_family)
        self._ops_sigma = ops_sigma
        if operator == "kron":
            self._ops = kron_cycle_ops(precision=precision, sigma=self.sigma)
        elif operator == "kron_blocked":
            self._ops = kron_blocked_cycle_ops(
                precision=precision, fuse_smoother=fuse_smoother,
                sigma=self.sigma, fuse_transfers=fuse_transfers)
        elif operator == "lattice":
            self._ops = lattice_cycle_ops(precision=precision,
                                          sigma=ops_sigma)
        elif operator == "lattice_blocked":
            self._ops = lattice_blocked_cycle_ops(precision=precision,
                                                  sigma=ops_sigma)
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
                    # The kernels consume the symmetrized form (with the
                    # separable bc masks when the marker is a union of
                    # box faces); the raw 1D factors are not needed at
                    # runtime.
                    from ..ops.kron_blocked import (
                        checked_face_masks,
                        symmetrized_mats,
                    )

                    lv["kb_mats"] = symmetrized_mats(
                        (lv["Kx"], lv["Ky"], lv["Kz"]),
                        (lv["mx"], lv["my"], lv["mz"]), dtype,
                        checked_face_masks(mesh, P, bc_np),
                        band=P, device=self.device,
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
                    # The pointwise shift (`_baked_m3_np`: the bc-zeroed
                    # lumped mass, field-scaled, Robin mass baked in),
                    # added in the apply and to the Jacobi diagonal.
                    lv["m3"] = tensor(self._baked_m3_np(mesh, P))
                    diag = diag + ops_sigma * lv["m3"]
            lv["diag_inv"] = 1.0 / diag
            if self._line_axis is not None:
                # Dense within-line block inverses of the assembled
                # (bc-applied, sigma-shifted) operator (solvers/line.py).
                lv["line_inv"] = tensor(line_block_inverses(
                    mesh, P, kappa, self._line_axis, sigma=self.sigma))
                level = dataclasses.replace(level, line_axis=self._line_axis,
                                            shape=shape)
            elif self._schwarz:
                from .schwarz import build_schwarz

                lv["schwarz"] = build_schwarz(mesh, P, kappa, dtype,
                                              sigma=self.sigma,
                                              device=self.device)
                level = dataclasses.replace(level, shape=shape)
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

        if coarse == "direct":
            self.data["coarse_chol"] = tensor(dense_cholesky(
                mesh, self.degrees[0], self.kappa_cells, self.sigma,
                sigma_field))
        elif coarse == "hmg":
            cfg = self.coarse_cfg
            kw = dict(smoother_iters=smoother_iters, precision=precision,
                      bottom=cfg.get("bottom", "direct"),
                      min_cells=cfg.get("min_cells", 2), sigma=self.sigma,
                      sizes=cfg.get("sizes"),
                      smoother=cfg.get("smoother", "cheb"),
                      device=self.device)
            if (getattr(mesh, "is_axis_aligned", True)
                    and self.kappa_axes is not None
                    and sigma_field is None):
                from .hmg import build_hmg

                hmg_levels, hmg_data, hmg_bottom = build_hmg(
                    mesh, self.degrees[0], self.kappa_axes, dtype, **kw)
                hmg_ops = kron_cycle_ops(precision, sigma=self.sigma)
            else:
                # Curved hexes, variable or tensor kappa, a sigma field:
                # the rediscretised lattice h-hierarchy.
                from .hmg import build_hmg_general

                hmg_levels, hmg_data, hmg_bottom, hmg_ops = build_hmg_general(
                    mesh, self.degrees[0], self._kappa_raw, dtype,
                    sigma_field=sigma_field, **kw)
            self.data["hmg"] = hmg_data
            cfg.update(hmg_levels=hmg_levels, hmg_ops=hmg_ops,
                       hmg_bottom=hmg_bottom, cycles=cfg.get("cycles", 3))
        elif coarse == "fdm":
            from .fdm import FastDiagonalizationSolver

            fd = FastDiagonalizationSolver(
                mesh, self.degrees[0], kappa=self.kappa_axes,
                dtype=dtype, sigma=self.sigma, device=self.device,
            )
            self.data["fdm"] = dict(
                Vx=fd.Vs[0], Vy=fd.Vs[1], Vz=fd.Vs[2],
                Vxt=fd.Vts[0], Vyt=fd.Vts[1], Vzt=fd.Vts[2],
                dinv=fd.dinv, bc_global=fd.bc_marker,
            )
            self.coarse_cfg["fdm_shape"] = mesh.lattice_shape(self.degrees[0])
            self.coarse_cfg["fdm_trims"] = fd.trims

    def _baked_m3_np(self, m, P):
        """The pointwise shift vector (float64, host) of a general-backend
        level on mesh ``m``: `fem.assembly.general_shift_np`'s ``m3`` (the
        field-scaled lumped mass, with the Robin boundary mass and sigma
        baked in when the mesh has Robin faces)."""
        from ..fem.assembly import general_shift_np

        return general_shift_np(m, P, self.sigma, self._sigma_field)[1]

    def _warn_tensor(self):
        warn_tensor_stationary(
            self._kappa_fold, self.kappa_axes, self.operator_kind,
            line=self._line_axis is not None or self._schwarz)

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

    @property
    def ops(self):
        """The cycle-ops dict (apply/restrict/prolong/dot/zeros): the public
        handle for composing `v_cycle` or a Krylov loop with this
        hierarchy's operator backend."""
        return self._ops

    def _to_work(self, v, level=-1):
        v = torch.as_tensor(v, dtype=self.dtype, device=self.device)
        if self.operator_kind in ("kron", "kron_blocked"):
            return v.reshape(self.levels[level].shape)
        return v.reshape(-1)

    def operator(self, level=-1):
        """The fine-level (or chosen-level) operator as ``x -> A x``, with
        the hierarchy's sigma shift and Dirichlet rows, on flat vectors."""
        lv = self.data["levels"][level]
        lvl = self.levels[level]
        apply = self._ops["apply"]
        return lambda x: apply(lv, self._to_work(x, level), lvl).reshape(-1)

    def apply(self, b, u):
        """One V-cycle from iterate ``u`` (flat vectors)."""
        return self._vcycle(self._to_work(b), self._to_work(u)).reshape(-1)

    def _fmg_guess(self, bw):
        """The FMG initial guess for a working-layout rhs."""
        return fmg_initial_guess(self.data, bw, levels=self.levels,
                                 coarse=self.coarse,
                                 coarse_cfg=self.coarse_cfg, ops=self._ops)

    def solve(self, b, num_cycles=10, u0=None, residuals=True, fmg=False):
        """Stationary V-cycle iteration. Returns ``(u, residual_norms)``.

        ``fmg=True`` (and no ``u0``) starts from the full-multigrid guess
        instead of zero. The residual norms stay on the device and are
        read back once, at the end."""
        self._warn_tensor()
        b = self._to_work(b)
        if u0 is not None:
            u = self._to_work(u0)
        else:
            u = self._fmg_guess(b) if fmg else torch.zeros_like(b)
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
        """V-cycle-preconditioned flexible CG from zero (or, with
        ``fmg=True``, from the full-multigrid guess). Returns
        ``(u, niter)``.

        The loop reads its convergence flag on the host once per
        iteration (a CUDA graph or a fixed-count loop would remove that
        sync; later work)."""
        from .cg import fcg_solve

        lv_f = self.data["levels"][-1]
        b = self._to_work(b)
        u0 = self._fmg_guess(b) if fmg else torch.zeros_like(b)
        u, info = fcg_solve(
            self._fine_apply, b, u0,
            lambda r: self._vcycle(r, torch.zeros_like(r)),
            rtol=float(rtol), maxiter=int(maxiter),
            dot=lambda u_, v_: self._ops["dot"](u_, v_, lv_f),
        )
        return u.reshape(-1), int(info["niter"])

    def _refine_apply64(self):
        """``u64 -> A u64`` in float64 on the device for `solve_refined`:
        the Kronecker form on axis-aligned meshes with a constant diagonal
        kappa and no sigma field, else the lattice apply with f64 geometry
        (and the baked pointwise shift); built once."""
        if getattr(self, "_apply64", None) is not None:
            return self._apply64
        mesh, Pf, f64 = self.mesh, self.degrees[-1], torch.float64
        if (getattr(mesh, "is_axis_aligned", True)
                and self.kappa_axes is not None
                and self._sigma_field is None):
            from ..ops.kron import KronLaplacian

            self._apply64 = KronLaplacian(mesh, Pf, kappa=self.kappa_axes,
                                          dtype=f64, sigma=self.sigma,
                                          device=self.device)
            return self._apply64
        from ..fem.assembly import geometry_factors_np, scale_G
        from ..ops.lattice import (
            geometry_to_qlattice,
            lattice_laplacian_apply,
            lattice_mats,
        )

        G_cells, _ = geometry_factors_np(mesh, Pf, kappa=self._kappa_fold)
        G = torch.as_tensor(geometry_to_qlattice(
            scale_G(G_cells, self._kc, self._kappa_fold), mesh.nc, Pf),
            dtype=f64, device=self.device)
        mats = lattice_mats(mesh.nc, Pf, f64, self.device)
        bc = torch.tensor(mesh.boundary_dof_marker(Pf), device=self.device)
        shift = self._ops_sigma
        m3 = (torch.as_tensor(self._baked_m3_np(mesh, Pf), dtype=f64,
                              device=self.device)
              if shift else None)

        def apply64(u):  # u is flat: the general family's work layout
            if not shift:
                return lattice_laplacian_apply(u, mats, G, bc)
            Au = lattice_laplacian_apply(u, mats, G, bc, apply_bc=False)
            return torch.where(bc, u, Au + shift * m3 * u)

        self._apply64 = apply64
        return apply64

    def solve_refined(self, b, num_cycles=15, rtol=0.0, residuals=True,
                      u0=None, fmg=False):
        """Mixed-precision iterative refinement: a float64 outer residual
        with the working-dtype V-cycle as the error smoother,

            r64 = b64 - A64 u64 ;  e = Vcycle(r, 0) ;  u64 += e

        which converges past the f32 residual floor. The f64 apply is the
        Kronecker form on axis-aligned meshes, else the lattice apply.
        ``u0`` resumes from an iterate; ``fmg=True`` starts from the
        working-dtype FMG guess. Returns ``(u64, residual_norms)``: the
        f64 residual norm before each cycle. With ``rtol`` the loop stops
        once it falls below ``rtol * |b|`` (one host read per cycle);
        without, the norms are read back once, at the end."""
        self._warn_tensor()
        apply64 = self._refine_apply64()
        f64 = dict(device=self.device, dtype=torch.float64)
        # the f64 state shares the work layout (lattice-shaped for kron)
        b64 = torch.as_tensor(b).to(**f64).reshape(self._to_work(b).shape)
        if u0 is not None:
            u64 = torch.as_tensor(u0).to(**f64).reshape(b64.shape)
        elif fmg:
            u64 = self._fmg_guess(self._to_work(b)).to(torch.float64)
        else:
            u64 = torch.zeros_like(b64)
        r0 = float(torch.linalg.vector_norm(b64)) if rtol else None
        norms = []
        for _ in range(num_cycles):
            r64 = b64 - apply64(u64)
            rn = torch.linalg.vector_norm(r64)
            r = self._to_work(r64)
            e = self._vcycle(r, torch.zeros_like(r))
            u64 = u64 + e.to(torch.float64)
            norms.append(rn)
            if rtol and float(rn) < rtol * r0:
                break
        rnorms = ([float(v) for v in torch.stack(norms).cpu().numpy()]
                  if residuals and norms else [])
        return u64.reshape(-1), rnorms

    def solve_many(self, B, num_cycles=10):
        """`solve` over a leading right-hand-side axis: ``B`` is ``(nrhs,
        ndofs)``; returns ``(U, rnorms)`` with ``U`` of ``B``'s shape and
        ``rnorms`` a numpy ``(nrhs, num_cycles)`` array. The columns run
        one after another (the JAX package vmaps them), each exactly its
        single-RHS solve."""
        B = torch.as_tensor(B).to(device=self.device, dtype=self.dtype)
        cols = [self.solve(b, num_cycles=num_cycles) for b in B]
        U = torch.stack([u for u, _ in cols]).reshape(B.shape)
        return U, np.array([rn for _, rn in cols]).reshape(len(cols),
                                                           num_cycles)

    def solve_pcg_many(self, B, rtol=1e-8, maxiter=50):
        """`solve_pcg` over a leading right-hand-side axis. Returns ``(U,
        niters)`` with the per-column FCG counts (a numpy int array),
        each column's count and iterate its single-RHS ones."""
        B = torch.as_tensor(B).to(device=self.device, dtype=self.dtype)
        cols = [self.solve_pcg(b, rtol=rtol, maxiter=maxiter) for b in B]
        U = torch.stack([u for u, _ in cols]).reshape(B.shape)
        return U, np.array([n for _, n in cols], dtype=np.int64)
