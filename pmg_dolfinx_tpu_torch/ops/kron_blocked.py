"""Blocked Kronecker-sum apply: hand-written CUDA kernels and their plain
torch versions.

Port of `pmg_dolfinx_tpu.ops.pallas_kron_blocked` for the separable
Dirichlet marker of a box (the only marker the flagship solve has):

- `symmetrized_mats`, `axis_interior_masks`, `checked_face_masks`,
  `default_tiles` — host-side setup, as in the JAX package;
- `blocked_kron_apply` / `blocked_kron_residual` — the entry points. On a
  CPU tensor they run the plain torch version; on a CUDA tensor they
  launch the kernels of `csrc/kron_blocked.cu` (kernel 1 `kron_t1_m`, then
  kernel 2 `kron_t23_m`, whose residual form fuses ``r - A v``) or raise.
  There is no fallback from CUDA to the plain version;
- `plain_t1_m`, `plain_t23_m`, `plain_apply_m`, `plain_residual_m` — dense
  `torch.einsum` versions of the same functions in any float dtype (the
  ports of `_emu_t1` / `_emu_apply`), used by the CPU tests and compared
  with the kernels on the card by `chip_smoke.py`.

The kernels are built with ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/`` (keyed by a hash of the source) and bound through a
plain C interface with `ctypes`. `LAUNCHES` counts every kernel launch,
so a run can show that its main path went through the kernels.

Not ported yet (ROADMAP.md, Queue 2): the full-``bc``-operand kernels
for non-separable markers, the fused Chebyshev kernel, the device-grid
kernels and ``precision="high"`` (bf16x3).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "kron_blocked.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches since the last reset: kernel name -> count. Raised only
# where a wrapper launches its kernel.
LAUNCHES = {"t1_m": 0, "t23_m": 0, "t23_res_m": 0}

# The loaded library and the compiler's output of the build that made it.
_lib = None
BUILD_LOG = ""

_SEPARABLE_TODO = (
    "a Dirichlet marker that is not a union of box faces needs the "
    "full-bc kernels _kernel_t1/_kernel_t23/_kernel_t23_res, not ported "
    "yet (ROADMAP.md Queue 2, kernels #4-#6)")


def _np64(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, np.float64)


def symmetrized_mats(Ks, ms, face_masks, *, band, device,
                     dtype=torch.float32):
    """The symmetrized-scaling arrays the blocked kernels consume.

    ``Ks`` are the per-axis stiffness matrices (kappa folded in), ``ms``
    the lumped masses, ``face_masks`` the per-axis 0/1 interior vectors
    of `checked_face_masks`. With ``s_a = sqrt(m_a)`` and
    ``Kt_a = K_a / (s_a s_a^T)`` the apply is ``S (Kt ⊕) S``; the bc mask
    folds into the scale planes (``sxzm``, ``s23m``) and the epilogue
    vectors (``mx2``, ``myb``, ``mzrow``). Computed in float64, cast
    once. Names and shapes follow the JAX package, so its state converts
    directly (`utils.convert`).

    ``band`` is the half-bandwidth of every ``Kt_a`` (the degree P for
    the GLL stiffness): the kernels sum over the band only, so an entry
    outside it raises ValueError here.
    """
    if face_masks is None:
        raise NotImplementedError(_SEPARABLE_TODO)
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
    mx, my, mz = [_np64(m) for m in face_masks]
    arrays = dict(
        Ktx=Kts[0],
        Kty=Kts[1],
        KtzT=Kts[2].T.copy(),
        sx2d=ss[0][:, None],                            # (NX, 1)
        sycol=ss[1][:, None],                           # (NY, 1)
        sxzm=np.outer(mx * ss[0], mz * ss[2]),          # (NX, NZ)
        s23m=np.outer(my * ss[1], mz * ss[2]),          # (NY, NZ)
        mx2=mx[:, None],                                # (NX, 1)
        myb=my[:, None],                                # (NY, 1)
        mzrow=mz[None, :],                              # (1, NZ)
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


# --- CUDA kernels -------------------------------------------------------------

def _find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    return nvcc


def load_kernels():
    """Build (once per source hash) and load the kernel library.

    Raises RuntimeError when there is no CUDA device, no ``nvcc`` or the
    build fails; never returns a stand-in.
    """
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the kron_blocked CUDA kernels need a CUDA device; "
            "torch.cuda.is_available() is False")
    nvcc = _find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): cannot build "
            f"the kron_blocked CUDA kernels from {_SRC}")
    src = _SRC.read_bytes()
    digest = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    so = _BUILD_DIR / f"kron_blocked_{digest[:16]}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run([nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                              capture_output=True, text=True)
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {_SRC} (exit {proc.returncode}):\n"
                f"{BUILD_LOG}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.kron_t1_m_launch.argtypes = [vp] * 5 + [ci] * 4 + [vp]
    lib.kron_t1_m_launch.restype = ci
    lib.kron_t23_m_launch.argtypes = [vp] * 12 + [ci] * 4 + [cf, vp]
    lib.kron_t23_m_launch.restype = ci
    lib.kron_max_band.argtypes = []
    lib.kron_max_band.restype = ci
    _lib = lib
    return lib


def _expected_shapes(shape):
    NX, NY, NZ = shape
    return dict(Ktx=(NX, NX), Kty=(NY, NY), KtzT=(NZ, NZ), sx2d=(NX, 1),
                sycol=(NY, 1), sxzm=(NX, NZ), s23m=(NY, NZ), mx2=(NX, 1),
                myb=(NY, 1), mzrow=(1, NZ))


def _check_lattice(name, t, shape, device):
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"{name} must be a tensor on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_operands(x3, m):
    if x3.device.type != "cuda":
        raise ValueError(
            f"the kron_blocked kernels run on CUDA tensors, got {x3.device}")
    if x3.ndim != 3:
        raise ValueError(f"x must be lattice-shaped (3D), got {x3.ndim}D")
    shape = tuple(x3.shape)
    _check_lattice("x", x3, shape, x3.device)
    for name, s in _expected_shapes(shape).items():
        _check_lattice(name, m[name], s, x3.device)
    return shape, m["band"]


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


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
        stream = torch.cuda.current_stream(x3.device).cuda_stream
        rc = lib.kron_t1_m_launch(
            _ptr(x3), _ptr(m["myb"]), _ptr(m["Ktx"]), _ptr(m["sxzm"]),
            _ptr(out), NX, NY, NZ, band, ctypes.c_void_p(stream))
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
        stream = torch.cuda.current_stream(x3.device).cuda_stream
        rc = lib.kron_t23_m_launch(
            _ptr(x3), _ptr(m["mx2"]), _ptr(t1), _ptr(m["Kty"]),
            _ptr(m["KtzT"]), _ptr(m["sx2d"]), _ptr(m["sycol"]),
            _ptr(m["s23m"]), _ptr(m["myb"]), _ptr(m["mzrow"]),
            None if r3 is None else _ptr(r3), _ptr(out),
            NX, NY, NZ, band, float(sigma), ctypes.c_void_p(stream))
    name = "t23_m" if r3 is None else "t23_res_m"
    if rc != 0:
        raise RuntimeError(f"kron_{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return out


def _check_precision(precision):
    if precision == "high":
        raise NotImplementedError(
            "precision='high' (bf16x3 products) is not ported; the CUDA "
            "kernels run true f32 FMA ('highest')")
    if precision != "highest":
        raise ValueError(
            f"precision must be 'highest' or 'high', got {precision!r}")


def blocked_kron_apply(x3, mats, *, sigma=0.0, precision="highest"):
    """``A x`` on a lattice-shaped vector through the blocked kernel pair.

    ``mats`` is the dict from `symmetrized_mats`. A CPU tensor runs the
    plain torch version (any float dtype); a CUDA tensor launches the
    kernels (float32) or raises.
    """
    _check_precision(precision)
    if x3.device.type == "cpu":
        return plain_apply_m(x3, mats, sigma)
    return kron_t23_m(x3, kron_t1_m(x3, mats), mats, sigma)


def blocked_kron_residual(b3, u3, mats, *, sigma=0.0, precision="highest"):
    """Fused ``r = b - A u`` through kernel 1 and the residual kernel
    (plain torch version on CPU tensors)."""
    _check_precision(precision)
    if u3.device.type == "cpu":
        return plain_residual_m(b3, u3, mats, sigma)
    return kron_t23_m(u3, kron_t1_m(u3, mats), mats, sigma, r3=b3)
