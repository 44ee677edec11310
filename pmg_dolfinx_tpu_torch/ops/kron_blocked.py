"""Blocked Kronecker-sum apply: hand-written CUDA kernels and their plain
torch versions.

Port of `pmg_dolfinx_tpu.ops.pallas_kron_blocked`:

- `symmetrized_mats`, `axis_interior_masks`, `checked_face_masks`,
  `default_tiles` — host-side setup, as in the JAX package;
- `blocked_kron_apply` / `blocked_kron_residual` — the entry points, with
  the JAX signatures ``(x3, bc3, mats)`` / ``(b3, u3, bc3, mats)``. On a
  CPU tensor they run the plain torch version; on a CUDA tensor they
  launch the kernels of `csrc/kron_blocked.cu` or raise. With the
  separable arrays in ``mats`` (``"sxzm"``, a box's face masks) that is
  kernel 1 `kron_t1_m` then kernel 2 `kron_t23_m` (whose residual form
  fuses ``r - A v``) and ``bc3`` is not read; otherwise the full-bc pair
  `kron_t1` then `kron_t23` (apply or residual epilogue). There is no
  fallback from CUDA to the plain version;
- `blocked_kron_cheb4` — the fourth-kind Chebyshev smoother with the
  update fused into the full-bc kernels: each half-step is `kron_t1` then
  `kron_t23_cheb`, which writes ``(x', r', z')`` in one pass;
- `plain_t1_m`, `plain_t23_m`, `plain_apply_m`, `plain_residual_m` and the
  full-bc `plain_t1`, `plain_t23`, `plain_apply`, `plain_residual`,
  `plain_cheb_step`, `plain_cheb4` — dense `torch.einsum` versions of the
  same functions in any float dtype (the ports of `_emu_t1` / `_emu_apply` and of the
  emulated Chebyshev half-step), used by the CPU tests and compared with
  the kernels on the card by `chip_smoke.py`.

The kernels are built with ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/`` (keyed by a hash of the source, `ops.cuda_build`) and
bound through a plain C interface with `ctypes`. `LAUNCHES` counts every kernel launch,
so a run can show that its main path went through the kernels.

Not ported yet (ROADMAP.md, Queue 2): the device-grid kernels and
``precision="high"`` (bf16x3).
"""

import ctypes
from pathlib import Path

import numpy as np
import torch

from .cuda_build import build_and_load
from .cuda_build import check_operand as _check_lattice
from .cuda_build import find_nvcc as _find_nvcc
from .cuda_build import ptr as _ptr
from .cuda_build import stream_of

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "kron_blocked.cu"

# Kernel launches since the last reset: kernel name -> count. Raised only
# where a wrapper launches its kernel.
LAUNCHES = {"t1_m": 0, "t23_m": 0, "t23_res_m": 0, "t1": 0, "t23": 0,
            "t23_res": 0, "t23_cheb": 0}

# The loaded library and the compiler's output of the build that made it.
_lib = None
BUILD_LOG = ""

def _np64(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, np.float64)


def symmetrized_mats(Ks, ms, face_masks=None, *, band, device,
                     dtype=torch.float32):
    """The symmetrized-scaling arrays the blocked kernels consume.

    ``Ks`` are the per-axis stiffness matrices (kappa folded in), ``ms``
    the lumped masses. With ``s_a = sqrt(m_a)`` and
    ``Kt_a = K_a / (s_a s_a^T)`` the apply is ``S (Kt ⊕) S``: always
    ``Ktx, Kty, KtzT``, ``sx2d``, ``sycol`` and the scale planes ``sxz``,
    ``s23`` of the full-bc kernels. ``face_masks`` (the per-axis 0/1
    interior vectors of `checked_face_masks`) adds the separable set: the
    bc mask folded into the scale planes (``sxzm``, ``s23m``) and the
    epilogue vectors (``mx2``, ``myb``, ``mzrow``). Computed in float64,
    cast once. Names and shapes follow the JAX package, so its state
    converts directly (`utils.convert`).

    ``band`` is the half-bandwidth of every ``Kt_a`` (the degree P for
    the GLL stiffness): the kernels sum over the band only, so an entry
    outside it raises ValueError here.
    """
    Ks64 = [_np64(K) for K in Ks]
    ms64 = [_np64(m) for m in ms]
    ss = [np.sqrt(m) for m in ms64]
    Kts = [K / s[:, None] / s[None, :] for K, s in zip(Ks64, ss)]
    band = int(band)
    for name, Kt in zip("xyz", Kts):
        i, j = np.indices(Kt.shape)
        outside = np.abs(i - j) > band
        if np.any(Kt[outside] != 0.0):
            raise ValueError(
                f"Kt_{name} has nonzero entries outside the band "
                f"|i-j| <= {band}; the blocked kernels sum over the band "
                "only")
    arrays = dict(
        Ktx=Kts[0],
        Kty=Kts[1],
        KtzT=Kts[2].T.copy(),
        sx2d=ss[0][:, None],                            # (NX, 1)
        sxz=np.outer(ss[0], ss[2]),                     # (NX, NZ)
        sycol=ss[1][:, None],                           # (NY, 1)
        s23=np.outer(ss[1], ss[2]),                     # (NY, NZ)
    )
    if face_masks is not None:
        mx, my, mz = [_np64(m) for m in face_masks]
        arrays.update(
            sxzm=np.outer(mx * ss[0], mz * ss[2]),      # (NX, NZ)
            s23m=np.outer(my * ss[1], mz * ss[2]),      # (NY, NZ)
            mx2=mx[:, None],                            # (NX, 1)
            myb=my[:, None],                            # (NY, 1)
            mzrow=mz[None, :],                          # (1, NZ)
        )
    out = {k: torch.as_tensor(v, dtype=dtype, device=device).contiguous()
           for k, v in arrays.items()}
    out["band"] = band
    return out


def checked_face_masks(mesh, P, bc_marker):
    """`axis_interior_masks` verified against the actual dof marker:
    the per-axis vectors iff their outer-product union equals
    ``bc_marker`` exactly, else None."""
    mx, my, mz = axis_interior_masks(mesh, P)
    interior = (mx[:, None, None] * my[None, :, None]
                * mz[None, None, :]) > 0.5
    bc3 = np.asarray(bc_marker).reshape(interior.shape)
    if np.array_equal(bc3, ~interior):
        return mx, my, mz
    return None


def axis_interior_masks(mesh, P):
    """Per-axis 0/1 interior vectors whose outer product is the box
    interior: 0 at the ends of axes whose faces carry Dirichlet flags."""
    faces = getattr(mesh, "dirichlet_faces", ((True, True),) * 3)
    masks = []
    for a in range(3):
        n = mesh.nc[a] * P + 1
        m = np.ones(n)
        lo, hi = faces[a]
        if lo:
            m[0] = 0.0
        if hi:
            m[-1] = 0.0
        masks.append(m)
    return masks


def default_tiles(P):
    """The JAX package's per-degree (by, bx) TPU slab sizes. The CUDA
    kernels fix their own 32 x 32 output tiles; kept so the setup layer
    maps 1:1 onto its reference."""
    return (8, 8) if P <= 6 else (4, 8)


# --- plain torch versions ---------------------------------------------------

def plain_t1_m(x3, m):
    """Kernel 1: ``t1' = Ktx-contraction of (x * my_j * sxzm)``."""
    w = x3 * (m["myb"][None, :, :] * m["sxzm"][:, None, :])
    return torch.einsum("ax,xyz->ayz", m["Ktx"], w)


def plain_t23_m(x3, t1, m, sigma=0.0):
    """Kernel 2: the y/z contractions, scaling and bc epilogue on t1'."""
    mx = m["mx2"][:, 0][:, None, None]
    what = x3 * (mx * m["s23m"][None])
    t2 = torch.einsum("by,xyz->xbz", m["Kty"], what)
    t3 = torch.einsum("xyz,zc->xyc", what, m["KtzT"])
    sx = m["sx2d"][:, 0][:, None, None]
    sy = m["sycol"][:, 0][None, :, None]
    acc = sy * t1 + sx * (t2 + t3)
    if sigma:
        acc = acc + (sigma * sx) * what
    y = acc * (sx * m["s23m"][None])
    inter_yz = (m["myb"] * m["mzrow"])[None]
    return x3 * (1.0 - mx * inter_yz) + y * mx


def plain_apply_m(x3, m, sigma=0.0):
    """``A x`` on a lattice-shaped vector (kernels 1 + 2)."""
    return plain_t23_m(x3, plain_t1_m(x3, m), m, sigma)


def plain_residual_m(b3, u3, m, sigma=0.0):
    """``b - A u`` on lattice-shaped vectors (kernels 1 + 3)."""
    return b3 - plain_apply_m(u3, m, sigma)


def plain_t1(x3, bc3, m):
    """Kernel #4: ``t1' = Ktx-contraction of (where(bc, 0, x) * sxz)``."""
    w = torch.where(bc3, torch.zeros_like(x3), x3) * m["sxz"][:, None, :]
    return torch.einsum("ax,xyz->ayz", m["Ktx"], w)


def plain_t23(x3, bc3, t1, m, sigma=0.0):
    """Kernel #5: the y/z contractions and scaling on t1', then the bc
    rows ``where(bc, x, y)``."""
    what = torch.where(bc3, torch.zeros_like(x3), x3) * m["s23"][None]
    t2 = torch.einsum("by,xyz->xbz", m["Kty"], what)
    t3 = torch.einsum("xyz,zc->xyc", what, m["KtzT"])
    sx = m["sx2d"][:, 0][:, None, None]
    sy = m["sycol"][:, 0][None, :, None]
    acc = sy * t1 + sx * (t2 + t3)
    if sigma:
        acc = acc + (sigma * sx) * what
    return torch.where(bc3, x3, acc * (sx * m["s23"][None]))


def plain_apply(x3, bc3, m, sigma=0.0):
    """``A x`` with the full bc array (kernels #4 + #5)."""
    return plain_t23(x3, bc3, plain_t1(x3, bc3, m), m, sigma)


def plain_residual(b3, u3, bc3, m, sigma=0.0):
    """``b - A u`` with the full bc array (kernels #4 + #6)."""
    return b3 - plain_apply(u3, bc3, m, sigma)


def cheb_coefs(lmax, k, dtype, device):
    """The ``(gamma, a, b)`` of fused Chebyshev half-step ``k`` as 0-d
    tensors, computed in ``dtype`` as the JAX package does: ``(0, 0,
    4/(3 lmax))`` for the init step ``k = 0``, ``(1, (2k-1)/(2k+3),
    (8k+4)/((2k+3) lmax))`` for loop step ``k >= 1``."""
    lm = torch.as_tensor(lmax, dtype=dtype, device=device)
    if k == 0:
        zero = torch.zeros((), dtype=dtype, device=device)
        return zero, zero, 4.0 / (3.0 * lm)
    kf = torch.tensor(float(k), dtype=dtype, device=device)
    return (torch.ones((), dtype=dtype, device=device),
            (2.0 * kf - 1.0) / (2.0 * kf + 3.0),
            (8.0 * kf + 4.0) / ((2.0 * kf + 3.0) * lm))


def plain_cheb_step(v3, bc3, x3, r3, dinv3, coefs, m, sigma=0.0, t1=None):
    """Kernel #7 (after kernel #4, or on the given ``t1``): one fused
    Chebyshev half-step ``(x + gamma v, r - A v, a v + b dinv (r - A v))``
    with ``coefs = (gamma, a, b)`` from `cheb_coefs`."""
    if t1 is None:
        t1 = plain_t1(v3, bc3, m)
    gamma, a, b = coefs
    r_new = r3 - plain_t23(v3, bc3, t1, m, sigma)
    return x3 + gamma * v3, r_new, a * v3 + b * dinv3 * r_new


def _cheb4(step, b3, x3, num_iters):
    """The recurrence of `blocked_kron_cheb4`: the init half-step with
    ``v = x``, then loop steps ``k = 1..num_iters`` with ``v = z``."""
    x, r, z = step(x3, x3, b3, 0)
    for k in range(1, num_iters + 1):
        x, r, z = step(z, x, r, k)
    return x


def plain_cheb4(b3, x3, bc3, mats, dinv3, lmax, num_iters, sigma=0.0):
    """`blocked_kron_cheb4` with every half-step `plain_cheb_step`, in any
    float dtype on any device (the CPU branch of the entry point, and the
    reference the kernels are held to on the card)."""
    def step(v, x, r, k):
        coefs = cheb_coefs(lmax, k, x3.dtype, x3.device)
        return plain_cheb_step(v, bc3, x, r, dinv3, coefs, mats, sigma)
    return _cheb4(step, b3, x3, num_iters)


# --- CUDA kernels -------------------------------------------------------------

def load_kernels():
    """Build (once per source hash) and load the kernel library.

    Raises RuntimeError when there is no CUDA device, no ``nvcc`` or the
    build fails; never returns a stand-in.
    """
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    lib, BUILD_LOG = build_and_load(_SRC, "kron_blocked", _find_nvcc)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.kron_t1_m_launch.argtypes = [vp] * 5 + [ci] * 4 + [vp]
    lib.kron_t1_m_launch.restype = ci
    lib.kron_t23_m_launch.argtypes = [vp] * 12 + [ci] * 4 + [cf, vp]
    lib.kron_t23_m_launch.restype = ci
    lib.kron_t1_launch.argtypes = [vp] * 5 + [ci] * 4 + [vp]
    lib.kron_t1_launch.restype = ci
    lib.kron_t23_launch.argtypes = [vp] * 10 + [ci] * 4 + [cf, vp]
    lib.kron_t23_launch.restype = ci
    lib.kron_t23_cheb_launch.argtypes = ([vp] * 12 + [ci] + [vp] * 3
                                         + [ci] * 4 + [cf, vp])
    lib.kron_t23_cheb_launch.restype = ci
    lib.kron_max_band.argtypes = []
    lib.kron_max_band.restype = ci
    _lib = lib
    return lib


def _expected_shapes(shape, separable):
    NX, NY, NZ = shape
    common = dict(Ktx=(NX, NX), Kty=(NY, NY), KtzT=(NZ, NZ), sx2d=(NX, 1),
                  sycol=(NY, 1))
    if separable:
        return dict(common, sxzm=(NX, NZ), s23m=(NY, NZ), mx2=(NX, 1),
                    myb=(NY, 1), mzrow=(1, NZ))
    return dict(common, sxz=(NX, NZ), s23=(NY, NZ))


def _check_operands(x3, m, bc3=None):
    """Check the lattice ``x3``, the arrays of ``m`` (the separable set
    unless ``bc3`` is given) and the bool marker ``bc3``."""
    if x3.device.type != "cuda":
        raise ValueError(
            f"the kron_blocked kernels run on CUDA tensors, got {x3.device}")
    if x3.ndim != 3:
        raise ValueError(f"x must be lattice-shaped (3D), got {x3.ndim}D")
    shape = tuple(x3.shape)
    _check_lattice("x", x3, shape, x3.device)
    for name, s in _expected_shapes(shape, bc3 is None).items():
        _check_lattice(name, m[name], s, x3.device)
    if bc3 is not None:
        _check_lattice("bc", bc3, shape, x3.device, torch.bool)
    return shape, m["band"]


def _kernels_for(band):
    lib = load_kernels()
    if not 0 <= band <= lib.kron_max_band():
        raise ValueError(
            f"band {band} exceeds the kernels' tiles (at most "
            f"{lib.kron_max_band()}, i.e. degree P <= {lib.kron_max_band()})")
    return lib


def kron_t1_m(x3, m):
    """Launch kernel 1 on CUDA tensors; returns a new ``t1'`` lattice."""
    (NX, NY, NZ), band = _check_operands(x3, m)
    lib = _kernels_for(band)
    out = torch.empty_like(x3)
    with torch.cuda.device(x3.device):
        rc = lib.kron_t1_m_launch(
            _ptr(x3), _ptr(m["myb"]), _ptr(m["Ktx"]), _ptr(m["sxzm"]),
            _ptr(out), NX, NY, NZ, band, stream_of(x3))
    if rc != 0:
        raise RuntimeError(f"kron_t1_m launch failed: CUDA error {rc}")
    LAUNCHES["t1_m"] += 1
    return out


def kron_t23_m(x3, t1, m, sigma=0.0, r3=None):
    """Launch kernel 2 (``A x``), or kernel 3 (``r - A x``) when ``r3``
    is given, on CUDA tensors; returns a new lattice."""
    shape, band = _check_operands(x3, m)
    _check_lattice("t1", t1, shape, x3.device)
    if r3 is not None:
        _check_lattice("r", r3, shape, x3.device)
    NX, NY, NZ = shape
    lib = _kernels_for(band)
    out = torch.empty_like(x3)
    with torch.cuda.device(x3.device):
        rc = lib.kron_t23_m_launch(
            _ptr(x3), _ptr(m["mx2"]), _ptr(t1), _ptr(m["Kty"]),
            _ptr(m["KtzT"]), _ptr(m["sx2d"]), _ptr(m["sycol"]),
            _ptr(m["s23m"]), _ptr(m["myb"]), _ptr(m["mzrow"]),
            None if r3 is None else _ptr(r3), _ptr(out),
            NX, NY, NZ, band, float(sigma), stream_of(x3))
    name = "t23_m" if r3 is None else "t23_res_m"
    if rc != 0:
        raise RuntimeError(f"kron_{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return out


def kron_t1(x3, bc3, m):
    """Launch kernel #4 (``t1'`` with the full bool marker ``bc3``) on
    CUDA tensors; returns a new lattice."""
    (NX, NY, NZ), band = _check_operands(x3, m, bc3)
    lib = _kernels_for(band)
    out = torch.empty_like(x3)
    with torch.cuda.device(x3.device):
        rc = lib.kron_t1_launch(
            _ptr(x3), _ptr(bc3), _ptr(m["Ktx"]), _ptr(m["sxz"]), _ptr(out),
            NX, NY, NZ, band, stream_of(x3))
    if rc != 0:
        raise RuntimeError(f"kron_t1 launch failed: CUDA error {rc}")
    LAUNCHES["t1"] += 1
    return out


def _t23_args(v3, bc3, t1, m):
    return (_ptr(v3), _ptr(bc3), _ptr(t1), _ptr(m["Kty"]), _ptr(m["KtzT"]),
            _ptr(m["sx2d"]), _ptr(m["sycol"]), _ptr(m["s23"]))


def kron_t23(v3, bc3, t1, m, sigma=0.0, r3=None):
    """Launch kernel #5 (``where(bc, v, y)``), or kernel #6 (``r - A v``)
    when ``r3`` is given, on CUDA tensors; returns a new lattice."""
    shape, band = _check_operands(v3, m, bc3)
    _check_lattice("t1", t1, shape, v3.device)
    if r3 is not None:
        _check_lattice("r", r3, shape, v3.device)
    NX, NY, NZ = shape
    lib = _kernels_for(band)
    out = torch.empty_like(v3)
    with torch.cuda.device(v3.device):
        rc = lib.kron_t23_launch(
            *_t23_args(v3, bc3, t1, m), None if r3 is None else _ptr(r3),
            _ptr(out), NX, NY, NZ, band, float(sigma), stream_of(v3))
    name = "t23" if r3 is None else "t23_res"
    if rc != 0:
        raise RuntimeError(f"kron_{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return out


def kron_t23_cheb(v3, bc3, t1, m, x3, r3, dinv3, lmax, k, sigma=0.0):
    """Launch kernel #7, Chebyshev half-step ``k`` (0: the init step,
    ``v = x``), on CUDA tensors. ``lmax`` is a 0-d float32 tensor on the
    device (read there: no host sync). Returns three new lattices
    ``(x', r', z')``; no input is written."""
    shape, band = _check_operands(v3, m, bc3)
    for name, t in (("t1", t1), ("x", x3), ("r", r3), ("dinv", dinv3)):
        _check_lattice(name, t, shape, v3.device)
    _check_lattice("lmax", lmax, (), v3.device)
    NX, NY, NZ = shape
    lib = _kernels_for(band)
    xo, ro, zo = (torch.empty_like(v3) for _ in range(3))
    with torch.cuda.device(v3.device):
        rc = lib.kron_t23_cheb_launch(
            *_t23_args(v3, bc3, t1, m), _ptr(x3), _ptr(r3), _ptr(dinv3),
            _ptr(lmax), int(k), _ptr(xo), _ptr(ro), _ptr(zo), NX, NY, NZ,
            band, float(sigma), stream_of(v3))
    if rc != 0:
        raise RuntimeError(f"kron_t23_cheb launch failed: CUDA error {rc}")
    LAUNCHES["t23_cheb"] += 1
    return xo, ro, zo


def _check_precision(precision):
    """The port's precision policy: true f32/f64 products ('highest')."""
    if precision == "high":
        raise NotImplementedError(
            "precision='high' (bf16x3 products) is not ported (ROADMAP.md "
            "Queue 1 item 1); the port runs true f32/f64 ('highest')")
    if precision != "highest":
        raise ValueError(
            f"precision must be 'highest' or 'high', got {precision!r}")


def blocked_kron_apply(x3, bc3, mats, *, sigma=0.0, precision="highest"):
    """``A x`` on a lattice-shaped vector through the blocked kernel pair.

    ``bc3`` is the lattice-shaped bool Dirichlet marker, ``mats`` the dict
    from `symmetrized_mats`. With its separable arrays (``"sxzm"``) the
    masks come from ``mats`` and ``bc3`` is not read (kernels #1 + #2);
    otherwise the full-bc kernels #4 + #5. A CPU tensor runs the plain
    torch version (any float dtype); a CUDA tensor launches the kernels
    (float32) or raises.
    """
    _check_precision(precision)
    separable = "sxzm" in mats
    if x3.device.type == "cpu":
        if separable:
            return plain_apply_m(x3, mats, sigma)
        return plain_apply(x3, bc3, mats, sigma)
    if separable:
        return kron_t23_m(x3, kron_t1_m(x3, mats), mats, sigma)
    return kron_t23(x3, bc3, kron_t1(x3, bc3, mats), mats, sigma)


def blocked_kron_residual(b3, u3, bc3, mats, *, sigma=0.0,
                          precision="highest"):
    """Fused ``r = b - A u`` through kernel 1 and a residual kernel (#1 +
    #3 with the separable arrays, else #4 + #6; the plain torch version
    on CPU tensors)."""
    _check_precision(precision)
    separable = "sxzm" in mats
    if u3.device.type == "cpu":
        if separable:
            return plain_residual_m(b3, u3, mats, sigma)
        return plain_residual(b3, u3, bc3, mats, sigma)
    if separable:
        return kron_t23_m(u3, kron_t1_m(u3, mats), mats, sigma, r3=b3)
    return kron_t23(u3, bc3, kron_t1(u3, bc3, mats), mats, sigma, r3=b3)


def blocked_kron_cheb4(b3, x3, bc3, mats, dinv3, lmax, num_iters, *,
                       sigma=0.0, precision="highest"):
    """Fourth-kind Chebyshev smoothing of ``A x = b`` from ``x3`` with the
    update fused into the full-bc kernels: the recurrence of
    `solvers.chebyshev.chebyshev4_solve` with ``1 + num_iters`` half-steps,
    each kernel #4 then kernel #7 (the plain torch half-step on CPU
    tensors). ``lmax`` is a 0-d tensor (or a float); on the card it is
    read by the kernel, so the smoother makes no host sync. Returns the
    new ``x``; the inputs are not written."""
    _check_precision(precision)
    if x3.device.type == "cpu":
        return plain_cheb4(b3, x3, bc3, mats, dinv3, lmax, num_iters, sigma)
    lm = torch.as_tensor(lmax, dtype=torch.float32, device=x3.device)

    def step(v, x, r, k):
        return kron_t23_cheb(v, bc3, kron_t1(v, bc3, mats), mats, x, r,
                             dinv3, lm, k, sigma)
    return _cheb4(step, b3, x3, num_iters)


class PallasKronBlocked:
    """The blocked kernel pair as an operator (float32) on ``device``:
    ``op(x)`` on flat or lattice-shaped vectors, with the diagonal of
    `ops.kron.KronLaplacian`."""

    def __init__(self, mesh, P, kappa=2.0, precision="highest", sigma=0.0,
                 *, device):
        from .kron import KronLaplacian

        _check_precision(precision)
        base = KronLaplacian(mesh, P, kappa=kappa, dtype=torch.float32,
                             sigma=sigma, device=device)
        self.P = int(P)
        self.mesh = mesh
        self.ndofs = base.ndofs
        self.shape = base.shape
        self.precision = precision
        self.sigma = base.sigma
        self.diag = base.diag
        self.diag_inv = base.diag_inv
        self.bc3 = base.bc_marker.reshape(self.shape)
        self.mats = symmetrized_mats(
            base.Ks, base.ms,
            checked_face_masks(mesh, P, mesh.boundary_dof_marker(P)),
            band=P, device=device)

    def __call__(self, x):
        y = blocked_kron_apply(x.reshape(self.shape), self.bc3, self.mats,
                               sigma=self.sigma, precision=self.precision)
        return y.reshape(x.shape)
