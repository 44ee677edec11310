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
  `kron_t1` then `kron_t23` (apply or residual epilogue): the same two
  marches reading the marker byte beside x, kernel 2 as the staged tile
  above band `T23_MARCH_MAX_BAND` (`t23_plan`). There is no fallback from
  CUDA to the plain version;
- `blocked_kron_cheb4` — the fourth-kind Chebyshev smoother with the
  update fused into the full-bc kernels: each half-step is `kron_t1` then
  `kron_t23_cheb`, which writes ``(x', r', z')`` in one pass;
- `plain_t1_m`, `plain_t23_m`, `plain_apply_m`, `plain_residual_m` and the
  full-bc `plain_t1`, `plain_t23`, `plain_apply`, `plain_residual`,
  `plain_cheb_step`, `plain_cheb4` — dense `torch.einsum` versions of the
  same functions in any float dtype (the ports of `_emu_t1` / `_emu_apply` and of the
  emulated Chebyshev half-step), used by the CPU tests and compared with
  the kernels on the card by `chip_smoke.py`;
- the device-grid half: `grid_symmetrized_mats`, `shard_blocks`,
  `edge_partials` and `blocked_kron_apply_grid`. On a shard, kernel 2 takes
  the neighbour corrections ``cy`` / ``cz`` (added before the final
  scaling): `kron_t23_m` / `kron_t23` with either correction given launch
  kernels #9 / #8 (`kron_t23_grid_m` / `kron_t23_grid` are the same
  functions under the names of the JAX package's kernels), and
  `plain_t23_m` / `plain_t23` are their plain versions.

The kernels are built with ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/`` (keyed by a hash of the source, `ops.cuda_build`) and
bound through a plain C interface with `ctypes`. `LAUNCHES` counts every kernel launch,
so a run can show that its main path went through the kernels.

Precision. ``precision="highest"`` (the default) sums true f32 products.
``precision="high"`` is the JAX package's bf16x3 contract:

- where the JAX package splits explicitly (every Pallas kernel with a
  ``high`` flag: #1-#9 here, K-A / K-B of `ops.lattice_blocked`), the port
  splits the same operands. Each operand ``a`` of a contraction becomes
  ``hi = bf16_rne(a)``, ``lo = bf16_rne(a - hi)`` (`split_bf16`); the
  products ``hi*hi``, ``hi*lo`` and ``lo*hi`` are accumulated in f32, each
  on its own, ``lo*lo`` is dropped, and the sum is ``hh + (hl + lh)``
  (`dot3`, the JAX package's ``_dot3``). Kernels #1 / #4 split ``Ktx``
  and the masked, scaled ``w``; #2, #3, #5-#9 split ``Kty``, ``KtzT`` and
  the masked, scaled ``w^``; ``t1'``, the ``s3`` scale, the ``sigma`` term
  and the epilogues stay f32. The kernels are the ``HIGH`` instantiations
  of the same source, a second library built the first time 'high' is
  asked for (`load_kernels`); their launches count under the kernel's
  name with ``_high`` appended. ~1e-5 relative error on O(1) data; the
  gap to 'highest' is 1e-6 to 1.5e-5 in the max norm (PERF.md §6);
- where the JAX package passes ``precision`` to XLA (the einsums of
  `ops.kron`, `ops.lattice`, `ops.unstructured`, `solvers.fdm`,
  `parallel.fdm_dist`), XLA picks per backend: bf16x3 on the TPU, exact
  f32 on the CPU backend the reference tests run on. The port computes
  those in f32 / f64 with TF32 off at both precisions, which meets the
  'high' contract and matches that CPU reference.
  ``torch.backends.cuda.matmul.allow_tf32`` is never switched on;
- the kernel families are f32 only at both precisions, as in JAX; the
  p-transfers and dots of a hierarchy stay at 'highest' (the JAX
  package's ``tprec``).
"""

import ctypes
from pathlib import Path

import numpy as np
import torch

from .cuda_build import build_and_load
from .cuda_build import check_operand as _check_lattice
from .cuda_build import find_nvcc as _find_nvcc
from .cuda_build import on_device as _on_device
from .cuda_build import ptr as _ptr
from .cuda_build import stream_of

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "kron_blocked.cu"

# Kernel launches since the last reset: kernel name -> count, the HIGH
# kernels (precision="high") under the name with "_high" appended. Raised
# only where a wrapper launches its kernel.
_KERNELS = ("t1_m", "t23_m", "t23_res_m", "t1", "t23", "t23_res", "t23_cheb",
            "t23_grid", "t23_grid_res", "t23_grid_m", "t23_grid_res_m")
LAUNCHES = {k + h: 0 for h in ("", "_high") for k in _KERNELS}

# The loaded libraries ('highest', and the HIGH instantiations built with
# -DPMG_HIGH=1), the compiler's output of the builds that made them and the
# largest band their kernels take (read from the library once).
_lib = None
_lib_high = None
BUILD_LOG = ""
BUILD_LOG_HIGH = ""
_MAX_BAND = None

# Kernels #5 / #6 / #8 run the y-march of kernel 2 with the marker byte up
# to this band; above it their residual form measured slower than the
# staged tile on the H100 (PERF.md section 6), and the tile serves them.
# The library compiles the march up to the same band (`kT23MarchMaxBand`)
# and refuses it above.
T23_MARCH_MAX_BAND = 12


def split_bf16(a):
    """``(hi, lo)`` bf16 parts of ``a`` with ``a ~= hi + lo``: ``hi =
    bf16_rne(a)``, ``lo = bf16_rne(a - hi)`` (the JAX package's
    ``pallas_util.split_bf16``, the operand split behind XLA's
    ``Precision.HIGH``). The difference ``a - hi`` is taken as XLA takes
    it on the CPU and the TPU: an operand below the smallest normal float
    counts as zero, and a result below it is flushed to a zero of its
    sign."""
    tiny = torch.finfo(a.dtype).tiny
    hi = a.to(torch.bfloat16)
    daz = lambda t: torch.where(t.abs() < tiny, torch.zeros_like(t), t)
    d = daz(a) - daz(hi.to(a.dtype))
    d = torch.where(d.abs() < tiny, d * 0.0, d)
    return hi, d.to(torch.bfloat16)


def dot3(eq, a_split, b_split, dtype=torch.float32):
    """bf16x3 contraction ``einsum(eq, a, b)`` of split operands (`split_bf16`):
    the products ``hi*hi``, ``hi*lo`` and ``lo*hi``, each accumulated in
    ``dtype`` (exact products in f32), ``lo*lo`` dropped, summed as ``hh +
    (hl + lh)`` (the JAX package's ``_dot3``)."""
    ah, al = (t.to(dtype) for t in a_split)
    bh, bl = (t.to(dtype) for t in b_split)
    return torch.einsum(eq, ah, bh) + (torch.einsum(eq, ah, bl)
                                       + torch.einsum(eq, al, bh))


def _contract(eq, a, b, high):
    """``einsum(eq, a, b)``: in bf16x3 (`dot3`) when ``high``."""
    if high:
        return dot3(eq, split_bf16(a), split_bf16(b), a.dtype)
    return torch.einsum(eq, a, b)


def _np64(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, np.float64)


def symmetrized_mats(Ks, ms, dtype=torch.float32, face_masks=None, *, band,
                     device):
    """The symmetrized-scaling arrays the blocked kernels consume.

    ``Ks`` are the per-axis stiffness matrices (kappa folded in), ``ms``
    the lumped masses. With ``s_a = sqrt(m_a)`` and
    ``Kt_a = K_a / (s_a s_a^T)`` the apply is ``S (Kt ⊕) S``: always
    ``Ktx, Kty, KtzT``, ``sx2d``, ``sycol`` and the scale planes ``sxz``,
    ``s23`` of the full-bc kernels. ``face_masks`` (the per-axis 0/1
    interior vectors of `checked_face_masks`) adds the separable set: the
    bc mask folded into the scale planes (``sxzm``, ``s23m``) and the
    epilogue vectors (``mx2``, ``myb``, ``mzrow``). Computed in float64,
    cast once to ``dtype``. Names, shapes and the positional order follow
    the JAX package, so its state converts directly (`utils.convert`).

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
        _check_band(name, Kt, band)
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


def _check_band(name, Kt, band):
    """Raise unless the square ``Kt`` is banded with half-width ``band``."""
    i, j = np.indices(Kt.shape)
    if np.any(Kt[np.abs(i - j) > band] != 0.0):
        raise ValueError(
            f"Kt_{name} has nonzero entries outside the band |i-j| <= "
            f"{band}; the blocked kernels sum over the band only")


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

def plain_t1_m(x3, m, high=False):
    """Kernel 1: ``t1' = Ktx-contraction of (x * my_j * sxzm)`` (in
    bf16x3 when ``high``, as every plain version below)."""
    w = x3 * (m["myb"][None, :, :] * m["sxzm"][:, None, :])
    return _contract("ax,xyz->ayz", m["Ktx"], w, high)


def _add_corrections(acc, sx2, cy, cz):
    """The neighbour corrections of kernels #8 / #9 on the accumulator's
    boundary planes (in place on ``acc``, the caller's own tensor)."""
    if cy is not None:
        acc[:, 0, :] += sx2 * cy[:, 0, :]
        acc[:, -1, :] += sx2 * cy[:, 1, :]
    if cz is not None:
        acc[:, :, 0] += sx2 * cz[:, :, 0]
        acc[:, :, -1] += sx2 * cz[:, :, 1]
    return acc


def _t2_t3(what, m, high):
    """Kernel 2's y / z contractions ``Kty w^`` and ``w^ KtzT``; in bf16x3
    ``w^`` is split once for both, as the JAX kernels do."""
    if not high:
        return (torch.einsum("by,xyz->xbz", m["Kty"], what),
                torch.einsum("xyz,zc->xyc", what, m["KtzT"]))
    ws = split_bf16(what)
    return (dot3("by,xyz->xbz", split_bf16(m["Kty"]), ws, what.dtype),
            dot3("xyz,zc->xyc", ws, split_bf16(m["KtzT"]), what.dtype))


def plain_t23_m(x3, t1, m, sigma=0.0, cy=None, cz=None, high=False):
    """Kernel 2: the y/z contractions, scaling and bc epilogue on t1'.
    On a device-grid shard (kernel #9) the neighbour corrections ``cy``
    (NX, 2, NZ) / ``cz`` (NX, NY, 2) are added to the accumulator's
    boundary planes before the final scaling."""
    mx = m["mx2"][:, 0][:, None, None]
    what = x3 * (mx * m["s23m"][None])
    t2, t3 = _t2_t3(what, m, high)
    sx = m["sx2d"][:, 0][:, None, None]
    sy = m["sycol"][:, 0][None, :, None]
    acc = sy * t1 + sx * (t2 + t3)
    if sigma:
        acc = acc + (sigma * sx) * what
    acc = _add_corrections(acc, m["sx2d"], cy, cz)
    y = acc * (sx * m["s23m"][None])
    inter_yz = (m["myb"] * m["mzrow"])[None]
    return x3 * (1.0 - mx * inter_yz) + y * mx


def plain_apply_m(x3, m, sigma=0.0, high=False):
    """``A x`` on a lattice-shaped vector (kernels 1 + 2)."""
    return plain_t23_m(x3, plain_t1_m(x3, m, high), m, sigma, high=high)


def plain_residual_m(b3, u3, m, sigma=0.0, high=False):
    """``b - A u`` on lattice-shaped vectors (kernels 1 + 3)."""
    return b3 - plain_apply_m(u3, m, sigma, high)


def plain_t1(x3, bc3, m, high=False):
    """Kernel #4: ``t1' = Ktx-contraction of (where(bc, 0, x) * sxz)``."""
    w = torch.where(bc3, torch.zeros_like(x3), x3) * m["sxz"][:, None, :]
    return _contract("ax,xyz->ayz", m["Ktx"], w, high)


def plain_t23(x3, bc3, t1, m, sigma=0.0, cy=None, cz=None, high=False):
    """Kernel #5: the y/z contractions and scaling on t1', then the bc
    rows ``where(bc, x, y)``; with ``cy`` / ``cz`` kernel #8 (the JAX
    package's ``_emu_t23_grid``), as in `plain_t23_m`."""
    what = torch.where(bc3, torch.zeros_like(x3), x3) * m["s23"][None]
    t2, t3 = _t2_t3(what, m, high)
    sx = m["sx2d"][:, 0][:, None, None]
    sy = m["sycol"][:, 0][None, :, None]
    acc = sy * t1 + sx * (t2 + t3)
    if sigma:
        acc = acc + (sigma * sx) * what
    acc = _add_corrections(acc, m["sx2d"], cy, cz)
    return torch.where(bc3, x3, acc * (sx * m["s23"][None]))


def plain_apply(x3, bc3, m, sigma=0.0, high=False):
    """``A x`` with the full bc array (kernels #4 + #5)."""
    return plain_t23(x3, bc3, plain_t1(x3, bc3, m, high), m, sigma,
                     high=high)


def plain_residual(b3, u3, bc3, m, sigma=0.0, high=False):
    """``b - A u`` with the full bc array (kernels #4 + #6)."""
    return b3 - plain_apply(u3, bc3, m, sigma, high)


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


def plain_cheb_step(v3, bc3, x3, r3, dinv3, coefs, m, sigma=0.0, t1=None,
                    high=False):
    """Kernel #7 (after kernel #4, or on the given ``t1``): one fused
    Chebyshev half-step ``(x + gamma v, r - A v, a v + b dinv (r - A v))``
    with ``coefs = (gamma, a, b)`` from `cheb_coefs`."""
    if t1 is None:
        t1 = plain_t1(v3, bc3, m, high)
    gamma, a, b = coefs
    r_new = r3 - plain_t23(v3, bc3, t1, m, sigma, high=high)
    return x3 + gamma * v3, r_new, a * v3 + b * dinv3 * r_new


def _cheb4(step, b3, x3, num_iters):
    """The recurrence of `blocked_kron_cheb4`: the init half-step with
    ``v = x``, then loop steps ``k = 1..num_iters`` with ``v = z``."""
    x, r, z = step(x3, x3, b3, 0)
    for k in range(1, num_iters + 1):
        x, r, z = step(z, x, r, k)
    return x


def plain_cheb4(b3, x3, bc3, mats, dinv3, lmax, num_iters, sigma=0.0,
                high=False):
    """`blocked_kron_cheb4` with every half-step `plain_cheb_step`, in any
    float dtype on any device (the CPU branch of the entry point, and the
    reference the kernels are held to on the card)."""
    def step(v, x, r, k):
        coefs = cheb_coefs(lmax, k, x3.dtype, x3.device)
        return plain_cheb_step(v, bc3, x, r, dinv3, coefs, mats, sigma,
                               high=high)
    return _cheb4(step, b3, x3, num_iters)


# --- CUDA kernels -------------------------------------------------------------

def load_kernels(high=False):
    """Build (once per source hash) and load the kernel library: the
    'highest' kernels, or with ``high`` the HIGH instantiations of the same
    source (-DPMG_HIGH=1, a library of its own, built at its first use).

    Raises RuntimeError when there is no CUDA device, no ``nvcc`` or the
    build fails; never returns a stand-in.
    """
    global _lib, _lib_high, BUILD_LOG, BUILD_LOG_HIGH, _MAX_BAND
    if high and _lib_high is not None:
        return _lib_high
    if not high and _lib is not None:
        return _lib
    if high:
        lib, BUILD_LOG_HIGH = build_and_load(_SRC, "kron_blocked_high",
                                             _find_nvcc, ("PMG_HIGH=1",))
    else:
        lib, BUILD_LOG = build_and_load(_SRC, "kron_blocked", _find_nvcc)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.kron_t1_m_launch.argtypes = [vp] * 5 + [ci] * 4 + [vp]
    lib.kron_t1_m_launch.restype = ci
    lib.kron_t23_m_launch.argtypes = [vp] * 14 + [ci] * 4 + [cf, vp]
    lib.kron_t23_m_launch.restype = ci
    lib.kron_t1_launch.argtypes = [vp] * 5 + [ci] * 4 + [vp]
    lib.kron_t1_launch.restype = ci
    lib.kron_t23_launch.argtypes = [vp] * 12 + [ci] * 4 + [cf, ci, vp]
    lib.kron_t23_launch.restype = ci
    lib.kron_t23_cheb_launch.argtypes = ([vp] * 12 + [ci] + [vp] * 3
                                         + [ci] * 4 + [cf, vp])
    lib.kron_t23_cheb_launch.restype = ci
    lib.kron_max_band.argtypes = []
    lib.kron_max_band.restype = ci
    lib.kron_high.argtypes = []
    lib.kron_high.restype = ci
    if lib.kron_high() != int(high):
        raise RuntimeError(f"{_SRC} built as the high={not high} library")
    _MAX_BAND = lib.kron_max_band()
    if high:
        _lib_high = lib
    else:
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


def _kernels_for(band, high):
    lib = load_kernels(high)
    if not 0 <= band <= _MAX_BAND:
        raise ValueError(
            f"band {band} exceeds the kernels' tiles (at most "
            f"{_MAX_BAND}, i.e. degree P <= {_MAX_BAND})")
    return lib


def _out(out, x3):
    """A new output lattice like ``x3``, or the caller's ``out`` (checked;
    it must not alias an input)."""
    if out is None:
        return torch.empty_like(x3)
    _check_lattice("out", out, tuple(x3.shape), x3.device)
    return out


def _plain_into(av, r3, out):
    """The CPU branch of a wrapper: the plain ``av`` (or ``r3 - av``), in
    ``out`` when given."""
    res = av if r3 is None else r3 - av
    if out is None:
        return res
    out.copy_(res)
    return out


def _opt(t):
    return None if t is None else _ptr(t)


def _t23_name(base, cy, cz, r3):
    """The `LAUNCHES` key of a kernel-2 launch: ``t23[_grid][_res]`` plus
    the separable suffix in ``base``."""
    grid = "_grid" if cy is not None or cz is not None else ""
    return "t23" + grid + ("" if r3 is None else "_res") + base


def _check_t23_extras(x3, t1, r3, cy, cz):
    NX, NY, NZ = shape = tuple(x3.shape)
    _check_lattice("t1", t1, shape, x3.device)
    if r3 is not None:
        _check_lattice("r", r3, shape, x3.device)
    if cy is not None:
        _check_lattice("cy", cy, (NX, 2, NZ), x3.device)
    if cz is not None:
        _check_lattice("cz", cz, (NX, NY, 2), x3.device)


def _hi(high):
    """The `LAUNCHES` suffix of a launch at ``high``."""
    return "_high" if high else ""


def kron_t1_m(x3, m, out=None, high=False):
    """Launch kernel 1 on CUDA tensors (`plain_t1_m` on CPU tensors);
    returns a new ``t1'`` lattice (or writes ``out``). ``high``: the bf16x3
    kernel, here and in every wrapper below."""
    if x3.device.type == "cpu":
        return _plain_into(plain_t1_m(x3, m, high), None, out)
    (NX, NY, NZ), band = _check_operands(x3, m)
    lib = _kernels_for(band, high)
    out = _out(out, x3)
    with _on_device(x3):
        rc = lib.kron_t1_m_launch(
            x3.data_ptr(), m["myb"].data_ptr(), m["Ktx"].data_ptr(),
            m["sxzm"].data_ptr(), out.data_ptr(), NX, NY, NZ, band,
            stream_of(x3))
    if rc != 0:
        raise RuntimeError(f"kron_t1_m launch failed: CUDA error {rc}")
    LAUNCHES["t1_m" + _hi(high)] += 1
    return out


def kron_t23_m(x3, t1, m, sigma=0.0, cy=None, cz=None, r3=None, out=None,
               high=False):
    """Launch kernel 2 (``A x``), or kernel 3 (``r - A x``) when ``r3``
    is given, on CUDA tensors; with either neighbour correction ``cy`` /
    ``cz`` of a device-grid shard, kernel #9 in the same two forms. A CPU
    tensor runs `plain_t23_m`. Returns a new lattice (or writes ``out``)."""
    if x3.device.type == "cpu":
        return _plain_into(plain_t23_m(x3, t1, m, sigma, cy, cz, high), r3,
                           out)
    (NX, NY, NZ), band = _check_operands(x3, m)
    _check_t23_extras(x3, t1, r3, cy, cz)
    lib = _kernels_for(band, high)
    out = _out(out, x3)
    with _on_device(x3):
        rc = lib.kron_t23_m_launch(
            x3.data_ptr(), m["mx2"].data_ptr(), t1.data_ptr(),
            m["Kty"].data_ptr(), m["KtzT"].data_ptr(), m["sx2d"].data_ptr(),
            m["sycol"].data_ptr(), m["s23m"].data_ptr(), m["myb"].data_ptr(),
            m["mzrow"].data_ptr(), _opt(cy), _opt(cz), _opt(r3),
            out.data_ptr(), NX, NY, NZ, band, float(sigma), stream_of(x3))
    name = _t23_name("_m", cy, cz, r3)
    if rc != 0:
        raise RuntimeError(f"kron_{name} launch failed: CUDA error {rc}")
    LAUNCHES[name + _hi(high)] += 1
    return out


def kron_t1(x3, bc3, m, out=None, high=False):
    """Launch kernel #4 (``t1'`` with the full bool marker ``bc3``) on
    CUDA tensors (`plain_t1` on CPU tensors); returns a new lattice (or
    writes ``out``)."""
    if x3.device.type == "cpu":
        return _plain_into(plain_t1(x3, bc3, m, high), None, out)
    (NX, NY, NZ), band = _check_operands(x3, m, bc3)
    lib = _kernels_for(band, high)
    out = _out(out, x3)
    with _on_device(x3):
        rc = lib.kron_t1_launch(
            x3.data_ptr(), bc3.data_ptr(), m["Ktx"].data_ptr(),
            m["sxz"].data_ptr(), out.data_ptr(), NX, NY, NZ, band,
            stream_of(x3))
    if rc != 0:
        raise RuntimeError(f"kron_t1 launch failed: CUDA error {rc}")
    LAUNCHES["t1" + _hi(high)] += 1
    return out


def t23_plan(band):
    """The form of kernels #5 / #6 / #8 at half-bandwidth ``band``:
    "march" (the y-march of kernel 2 with the marker byte) up to
    `T23_MARCH_MAX_BAND`, else "tile" (a staged 32 x 32 tile with a
    ``band``-wide halo)."""
    return "march" if band <= T23_MARCH_MAX_BAND else "tile"


def _t23_args(v3, bc3, t1, m):
    return (_ptr(v3), _ptr(bc3), _ptr(t1), _ptr(m["Kty"]), _ptr(m["KtzT"]),
            _ptr(m["sx2d"]), _ptr(m["sycol"]), _ptr(m["s23"]))


def kron_t23(v3, bc3, t1, m, sigma=0.0, cy=None, cz=None, r3=None,
             out=None, high=False):
    """Launch kernel #5 (``where(bc, v, y)``), or kernel #6 (``r - A v``)
    when ``r3`` is given, on CUDA tensors; with either neighbour
    correction ``cy`` / ``cz``, kernel #8 in the same two forms, each in
    the form `t23_plan` picks for the band. A CPU tensor runs
    `plain_t23`. Returns a new lattice (or writes ``out``, which must not
    alias an input)."""
    if v3.device.type == "cpu":
        return _plain_into(plain_t23(v3, bc3, t1, m, sigma, cy, cz, high),
                           r3, out)
    (NX, NY, NZ), band = _check_operands(v3, m, bc3)
    _check_t23_extras(v3, t1, r3, cy, cz)
    lib = _kernels_for(band, high)
    out = _out(out, v3)
    with torch.cuda.device(v3.device):
        rc = lib.kron_t23_launch(
            *_t23_args(v3, bc3, t1, m), _opt(cy), _opt(cz), _opt(r3),
            _ptr(out), NX, NY, NZ, band, float(sigma),
            int(t23_plan(band) == "march"), stream_of(v3))
    name = _t23_name("", cy, cz, r3)
    if rc != 0:
        raise RuntimeError(f"kron_{name} launch failed: CUDA error {rc}")
    LAUNCHES[name + _hi(high)] += 1
    return out


def kron_t23_cheb(v3, bc3, t1, m, x3, r3, dinv3, lmax, k, sigma=0.0,
                  high=False):
    """Launch kernel #7, Chebyshev half-step ``k`` (0: the init step,
    ``v = x``), on CUDA tensors. ``lmax`` is a 0-d float32 tensor on the
    device (read there: no host sync). Returns three new lattices
    ``(x', r', z')``; no input is written."""
    shape, band = _check_operands(v3, m, bc3)
    for name, t in (("t1", t1), ("x", x3), ("r", r3), ("dinv", dinv3)):
        _check_lattice(name, t, shape, v3.device)
    _check_lattice("lmax", lmax, (), v3.device)
    NX, NY, NZ = shape
    lib = _kernels_for(band, high)
    xo, ro, zo = (torch.empty_like(v3) for _ in range(3))
    with torch.cuda.device(v3.device):
        rc = lib.kron_t23_cheb_launch(
            *_t23_args(v3, bc3, t1, m), _ptr(x3), _ptr(r3), _ptr(dinv3),
            _ptr(lmax), int(k), _ptr(xo), _ptr(ro), _ptr(zo), NX, NY, NZ,
            band, float(sigma), stream_of(v3))
    if rc != 0:
        raise RuntimeError(f"kron_t23_cheb launch failed: CUDA error {rc}")
    LAUNCHES["t23_cheb" + _hi(high)] += 1
    return xo, ro, zo


def _tpu_knob(name, value, default):
    """The JAX package's TPU-only knobs (Pallas tile sizes, interpret
    mode) keep their positions in the port's signatures; anything but
    JAX's default raises."""
    if value != default:
        raise ValueError(
            f"{name}={value!r} is a TPU tile or mode knob of the JAX "
            "package's Pallas kernels; the CUDA kernels fix their own tiles "
            f"and take no interpret mode (leave it at {default!r})")


def _tpu_knobs(by, bx, interpret):
    """The JAX entry points' keyword tile sizes and interpret mode
    (``by=8, bx=8, interpret=None``): their defaults only."""
    _tpu_knob("by", by, 8)
    _tpu_knob("bx", bx, 8)
    _tpu_knob("interpret", interpret, None)


def _check_precision(precision):
    """Raise unless ``precision`` is 'highest' or 'high' (the policy in
    the module docstring); returns whether it is 'high'."""
    if precision not in ("highest", "high"):
        raise ValueError(
            f"precision must be 'highest' or 'high', got {precision!r}")
    return precision == "high"


def blocked_kron_apply(x3, bc3, mats, *, by=8, bx=8, precision="highest",
                       interpret=None, exchange=None, sigma=0.0):
    """``A x`` on a lattice-shaped vector through the blocked kernel pair.

    ``bc3`` is the lattice-shaped bool Dirichlet marker, ``mats`` the dict
    from `symmetrized_mats`. With its separable arrays (``"sxzm"``) the
    masks come from ``mats`` and ``bc3`` is not read (kernels #1 + #2);
    otherwise the full-bc kernels #4 + #5. A CPU tensor runs the plain
    torch version (any float dtype); a CUDA tensor launches the kernels
    (float32) or raises. ``exchange`` (optional) is applied to kernel 1's
    output, the x-stiffness term, before kernel 2 reads it: the interface
    partial-sum reconciliation of an x-sharded layout, as in the JAX
    package (it may write that tensor in place; it is this call's own).
    The JAX package's tile and mode knobs ``by``, ``bx``, ``interpret``
    take its defaults only (`_tpu_knobs`).
    """
    high = _check_precision(precision)
    _tpu_knobs(by, bx, interpret)
    t1 = _t1(x3, bc3, mats, high)
    if exchange is not None:
        t1 = exchange(t1)
    if "sxzm" in mats:
        return kron_t23_m(x3, t1, mats, sigma, high=high)
    return kron_t23(x3, bc3, t1, mats, sigma, high=high)


def _t1(x3, bc3, mats, high):
    """Kernel 1 of an apply: #1 with the separable arrays, else #4 (the
    plain version on CPU tensors)."""
    if "sxzm" in mats:
        return kron_t1_m(x3, mats, high=high)
    return kron_t1(x3, bc3, mats, high=high)


def blocked_kron_residual(b3, u3, bc3, mats, *, by=8, bx=8,
                          precision="highest", interpret=None, exchange=None,
                          sigma=0.0):
    """Fused ``r = b - A u`` through kernel 1 and a residual kernel (#1 +
    #3 with the separable arrays, else #4 + #6; the plain torch version
    on CPU tensors). ``exchange`` and the TPU knobs as in
    `blocked_kron_apply`."""
    high = _check_precision(precision)
    _tpu_knobs(by, bx, interpret)
    t1 = _t1(u3, bc3, mats, high)
    if exchange is not None:
        t1 = exchange(t1)
    if "sxzm" in mats:
        return kron_t23_m(u3, t1, mats, sigma, r3=b3, high=high)
    return kron_t23(u3, bc3, t1, mats, sigma, r3=b3, high=high)


def blocked_kron_cheb4(b3, x3, bc3, mats, dinv3, lmax, num_iters, *,
                       by=8, bx=8, precision="highest", interpret=None,
                       exchange=None, sigma=0.0):
    """Fourth-kind Chebyshev smoothing of ``A x = b`` from ``x3`` with the
    update fused into the full-bc kernels: the recurrence of
    `solvers.chebyshev.chebyshev4_solve` with ``1 + num_iters`` half-steps,
    each kernel #4 then kernel #7 (the plain torch half-step on CPU
    tensors). ``lmax`` is a 0-d tensor (or a float); on the card it is
    read by the kernel, so the smoother makes no host sync. ``exchange``
    as in `blocked_kron_apply`, on every half-step's kernel-1 output, and
    so are the TPU knobs. Returns the new ``x``; the inputs are not
    written."""
    high = _check_precision(precision)
    _tpu_knobs(by, bx, interpret)
    if x3.device.type == "cpu":
        if exchange is None:
            return plain_cheb4(b3, x3, bc3, mats, dinv3, lmax, num_iters,
                               sigma, high)

        def plain_step(v, x, r, k):
            coefs = cheb_coefs(lmax, k, x3.dtype, x3.device)
            return plain_cheb_step(
                v, bc3, x, r, dinv3, coefs, mats, sigma,
                t1=exchange(plain_t1(v, bc3, mats, high)), high=high)
        return _cheb4(plain_step, b3, x3, num_iters)
    lm = torch.as_tensor(lmax, dtype=torch.float32, device=x3.device)

    def step(v, x, r, k):
        t1 = kron_t1(v, bc3, mats, high=high)
        if exchange is not None:
            t1 = exchange(t1)
        return kron_t23_cheb(v, bc3, t1, mats, x, r, dinv3, lm, k, sigma,
                             high=high)
    return _cheb4(step, b3, x3, num_iters)


# --- the device-grid half: kernels #8 / #9 -----------------------------------
#
# A shard of a 2D/3D device grid (`parallel.grid2d`) holds the local lattice
# of its box with the interface planes duplicated. Its kernel 1 output is
# shard-partial only across x-interfaces (reconciled by ``exchange_x``), and
# the y/z contractions of its first/last y- and z-planes miss the neighbour
# shard's cells: those partial sums are computed from x (`edge_partials`),
# exchanged, and the received planes ``cy`` / ``cz`` are added by kernel 2
# before its final scaling (kernels #8 / #9). Inputs are one shard's 3D
# lattice with its local arrays, or the stacked ``(sx, sy, sz, NX, NY, NZ)``
# layout of every shard with the grid-stacked arrays of
# `grid_symmetrized_mats`; kernels 1 and 2 then run shard by shard.

# Per key of `grid_symmetrized_mats`: the grid axis its rows and its
# columns are stacked along (None: replicated).
_GRID_AXES = dict(
    Ktx=("x", None), Kty=("y", None), KtzT=("z", None), Ktye=("y", None),
    KtzTe=("z", None), sx2d=("x", None), sycol=("y", None), sxz=("x", "z"),
    s23=("y", "z"), sxzm=("x", "z"), s23m=("y", "z"), mx2=("x", None),
    myb=("y", None), mzrow=(None, "z"))


def grid_symmetrized_mats(Ks_local, ms_dup, shards, dtype=torch.float32,
                          face_masks_dup=None, *, band, device):
    """Per-shard symmetrized arrays of a device grid, stacked along each
    sharded axis (the JAX package's layout and order).

    ``Ks_local``: per-axis LOCAL 1D stiffness, ``(npl_a, npl_a)`` (one
    matrix for every shard of the axis) or row-stacked ``(S_a * npl_a,
    npl_a)`` (`ops.kron.local_axis_K`). ``ms_dup``: per-axis global lumped
    masses in the duplicated-plane layout ``(S_a * npl_a,)``; the sqrt-mass
    scalings differ between boundary and interior shards, so every scaled
    factor is built per shard and stacked. ``face_masks_dup`` (the separable
    bc masks in the same layout) adds ``sxzm``, ``s23m``, ``mx2``, ``myb``,
    ``mzrow``. ``Ktye`` / ``KtzTe`` are the interface rows of ``Kty`` /
    columns of ``KtzT`` that `edge_partials` contracts with. Built in
    float64, cast once to ``dtype``; ``band`` as in `symmetrized_mats`.
    Returns ``(mats, axes)``: the dict (with ``"band"``) and, per array,
    the grid axes its rows and columns are stacked along.
    """
    mx, my, mz = (_np64(m) for m in ms_dup)
    sx, sy, sz = np.sqrt(mx), np.sqrt(my), np.sqrt(mz)
    Sx, Sy, Sz = shards
    Kx, Ky, Kz = (_np64(K) for K in Ks_local)
    nplx, nply, nplz = Kx.shape[-1], Ky.shape[-1], Kz.shape[-1]
    Kx, Ky, Kz = (
        (K.reshape(S, npl, npl) if K.shape[0] == S * npl
         else np.broadcast_to(K, (S, npl, npl)))
        for K, S, npl in ((Kx, Sx, nplx), (Ky, Sy, nply), (Kz, Sz, nplz)))
    band = int(band)

    def stacked(name, K3, s_all, S, npl, pick=None, transpose=False):
        out = []
        for K, sl in zip(K3, s_all.reshape(S, npl)):
            Kt = K / sl[:, None] / sl[None, :]
            _check_band(name, Kt, band)
            if transpose:
                Kt = Kt.T.copy()
                if pick is not None:
                    Kt = Kt[:, pick]
            elif pick is not None:
                Kt = Kt[pick]
            out.append(Kt)
        return np.concatenate(out, axis=0)

    edge = np.array([0, -1])
    arrays = dict(
        Ktx=stacked("x", Kx, sx, Sx, nplx),
        Kty=stacked("y", Ky, sy, Sy, nply),
        KtzT=stacked("z", Kz, sz, Sz, nplz, transpose=True),
        Ktye=stacked("y", Ky, sy, Sy, nply, pick=edge),
        KtzTe=stacked("z", Kz, sz, Sz, nplz, transpose=True, pick=edge),
        sx2d=sx[:, None],
        sycol=sy[:, None],
        sxz=np.outer(sx, sz),
        s23=np.outer(sy, sz),
    )
    if face_masks_dup is not None:
        mxd, myd, mzd = (_np64(m) for m in face_masks_dup)
        arrays.update(
            sxzm=np.outer(mxd * sx, mzd * sz),
            s23m=np.outer(myd * sy, mzd * sz),
            mx2=mxd[:, None],
            myb=myd[:, None],
            mzrow=mzd[None, :],
        )
    out = {k: torch.as_tensor(v, dtype=dtype, device=device).contiguous()
           for k, v in arrays.items()}
    out["band"] = band
    return out, {k: _GRID_AXES[k] for k in arrays}


def shard_mats(mats, idx):
    """Shard ``idx = (i, j, k)``'s local arrays, each a contiguous copy,
    from the grid-stacked ``mats`` of `grid_symmetrized_mats`."""
    pos = dict(zip("xyz", idx))
    n = dict(x=mats["Ktx"].shape[1], y=mats["Kty"].shape[1],
             z=mats["KtzT"].shape[1])
    every = slice(None)
    out = {"band": mats["band"]}
    for key, (ra, ca) in _GRID_AXES.items():
        if key not in mats:
            continue
        rn = 2 if key == "Ktye" else n.get(ra)
        rows = every if ra is None else slice(pos[ra] * rn,
                                              (pos[ra] + 1) * rn)
        cols = every if ca is None else slice(pos[ca] * n[ca],
                                              (pos[ca] + 1) * n[ca])
        out[key] = mats[key][rows, cols].contiguous()
    return out


def shard_blocks(mats):
    """Every shard's `shard_mats`, keyed by shard index in the order of
    the stacked layout: cut once per level by the caller (`GridPMG`) and
    passed to `blocked_kron_apply_grid`."""
    S = [mats[k].shape[0] // mats[k].shape[1] for k in ("Ktx", "Kty", "KtzT")]
    return {(i, j, k): shard_mats(mats, (i, j, k)) for i in range(S[0])
            for j in range(S[1]) for k in range(S[2])}


def edge_partials(x3, bc3, m, need_y, need_z):
    """Pre-scaling partial sums of kernel 2's y / z contractions on the
    first and last local y- and z-planes, from x (the JAX package's
    ``_edge_partials``, torch einsums): ``t2b[x, e, z] = Ktye[e] @ what``
    and ``t3b[x, y, e] = what @ KtzTe[:, e]`` with ``what = where(bc, 0, x)
    * s23``. One shard's 3D lattice with its own arrays, or the stacked
    layout with the grid-stacked arrays (all shards in one contraction).
    Returns ``(t2b, t3b)``, None where not needed."""
    one = x3.ndim == 3
    if one:
        x3, bc3 = x3[None, None, None], bc3[None, None, None]
    Sy, Sz, nx, ny, nz = x3.shape[1:]
    s23 = m["s23"].reshape(Sy, ny, Sz, nz).permute(0, 2, 1, 3)
    w = torch.where(bc3, torch.zeros_like(x3), x3) * s23[None, :, :, None]
    t2b = (torch.einsum("jeb,ijkxbz->ijkxez", m["Ktye"].reshape(Sy, 2, ny),
                        w) if need_y else None)
    t3b = (torch.einsum("ijkxyz,kze->ijkxye", w,
                        m["KtzTe"].reshape(Sz, nz, 2)) if need_z else None)
    if one:
        t2b = None if t2b is None else t2b[0, 0, 0]
        t3b = None if t3b is None else t3b[0, 0, 0]
    return t2b, t3b


# Kernels #8 / #9 and their plain versions under the names of the JAX
# package's kernels: kernel 2 given a shard's corrections.
plain_t23_grid = plain_t23
plain_t23_grid_m = plain_t23_m
kron_t23_grid = kron_t23
kron_t23_grid_m = kron_t23_m


def blocked_kron_apply_grid(x3, bc3, mats, *, by=8, bx=8,
                            precision="highest", interpret=None,
                            exchange_x=None, ex_y=None, ex_z=None,
                            sigma=0.0, r3=None, blocks=None):
    """Blocked Kronecker apply under a 2D/3D device grid (the JAX
    package's signature).

    ``x3``/``bc3`` are one shard's 3D lattice and marker with its local
    ``mats``, or the stacked ``(sx, sy, sz, NX, NY, NZ)`` layout with the
    grid-stacked ``mats`` of `grid_symmetrized_mats` (``blocks``: their
    `shard_blocks`, cut here when not given). Three independent per-axis
    reconciliations, each a collective of `parallel.grid2d`:

    - ``exchange_x(t1)``: kernel 1's output (the x term) across
      x-interfaces;
    - ``ex_y(first, last) -> (add_first, add_last)``: the t2 edge partials
      (`edge_partials`) to the y-neighbours; the received planes ``cy``
      feed kernel 2;
    - ``ex_z``: the same for the t3 term across z-interfaces (``cz``).

    With ``r3`` kernel 2 emits the fused residual ``r3 - A x``. Kernel 2
    is #9 with the separable arrays (``"sxzm"`` in ``mats``), else #8; with
    neither ``ex_y`` nor ``ex_z`` one shard's call is `blocked_kron_apply`
    / `blocked_kron_residual` with ``exchange=exchange_x`` (kernels #1-#6),
    as in the JAX package. CPU tensors run the plain versions, CUDA tensors
    the kernels (per shard) or raise. ``by``, ``bx`` and ``interpret`` are
    the JAX package's TPU knobs (defaults only).
    """
    high = _check_precision(precision)
    _tpu_knobs(by, bx, interpret)
    need_y, need_z = ex_y is not None, ex_z is not None
    if x3.ndim == 3:
        if not (need_y or need_z):
            if r3 is not None:
                return blocked_kron_residual(r3, x3, bc3, mats, sigma=sigma,
                                             exchange=exchange_x,
                                             precision=precision)
            return blocked_kron_apply(x3, bc3, mats, sigma=sigma,
                                      exchange=exchange_x,
                                      precision=precision)
        blocks = {(): mats}
    elif blocks is None:
        blocks = shard_blocks(mats)
    x3, bc3 = x3.contiguous(), bc3.contiguous()
    r3 = None if r3 is None else r3.contiguous()
    cy = cz = None
    if need_y or need_z:
        # Edge partials from x, exchanged with the neighbours; the planes
        # received become kernel 2's correction inputs.
        t2b, t3b = edge_partials(x3, bc3, mats, need_y, need_z)
        if need_y:
            cy = torch.stack(ex_y(t2b[..., 0, :], t2b[..., 1, :]), dim=-2)
        if need_z:
            cz = torch.stack(ex_z(t3b[..., 0], t3b[..., 1]), dim=-1)
    separable = "sxzm" in mats
    t1 = torch.empty_like(x3)
    for idx, m in blocks.items():
        if separable:
            kron_t1_m(x3[idx], m, out=t1[idx], high=high)
        else:
            kron_t1(x3[idx], bc3[idx], m, out=t1[idx], high=high)
    if exchange_x is not None:
        t1 = exchange_x(t1)
    out = torch.empty_like(x3)
    part = lambda t, idx: None if t is None else t[idx]
    for idx, m in blocks.items():
        extra = dict(cy=part(cy, idx), cz=part(cz, idx), r3=part(r3, idx),
                     out=out[idx], high=high)
        if separable:
            kron_t23_m(x3[idx], t1[idx], m, sigma, **extra)
        else:
            kron_t23(x3[idx], bc3[idx], t1[idx], m, sigma, **extra)
    return out


class PallasKronBlocked:
    """The blocked kernel pair as an operator (float32) on ``device``:
    ``op(x)`` on flat or lattice-shaped vectors, with the diagonal of
    `ops.kron.KronLaplacian`. The parameters keep the JAX package's
    order; its TPU knobs ``by``, ``bx`` and ``interpret`` take their
    defaults only."""

    def __init__(self, mesh, P, kappa=2.0, by=None, bx=None, interpret=False,
                 precision="highest", sigma=0.0, *, device):
        from .kron import KronLaplacian

        _tpu_knob("by", by, None)
        _tpu_knob("bx", bx, None)
        _tpu_knob("interpret", interpret, False)
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
            face_masks=checked_face_masks(mesh, P,
                                          mesh.boundary_dof_marker(P)),
            band=P, device=device)

    def __call__(self, x):
        y = blocked_kron_apply(x.reshape(self.shape), self.bc3, self.mats,
                               sigma=self.sigma, precision=self.precision)
        return y.reshape(x.shape)
