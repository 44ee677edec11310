"""Kronecker apply and FDM direct solve for small lattices (serving):
hand-written CUDA kernels and their plain torch versions.

Port of `pmg_dolfinx_tpu.ops.pallas_kron_packed`. The JAX package packs
``g = 128 // Zp`` right-hand sides (`PackedKronBatch`, `PackedFDMBatch`)
or a single lattice's own x-slabs (`PackedKronSingle`, `PackedFDMSingle`)
into the TPU's 128-lane tiles, with a k-augmented x matrix ``XC`` and
lane rolls for the slab coupling. All of that fills lanes the card does
not have, so the port keeps the functions and drops the packing:

- `pack` gives a contiguous ``(B, NX, NY, NZ)`` float32 tensor
  (``(NX, NY, NZ)`` for the single classes) and `unpack` is its inverse;
- `apply_packed` is, per right-hand side,
  ``where(bc, x, s3 (Ktx.w +x Kty.w +y Ktz.w +z sigma w))`` with
  ``w = where(bc, 0, x) s3`` (`_emu_apply`);
- `solve_packed` is ``where(bc, b, Vx Vy Vz (dinv Vzt Vyt Vxt b))`` with
  the boundary-embedded per-axis eigenvectors (`_emu_fdm`);
- the single classes compute the same functions at B = 1 on the same
  factors.

`packed_apply` and `packed_fdm` are the entry points: on a CPU tensor they
run `plain_packed_apply` / `plain_packed_fdm` (torch einsums, what the
tests compare with JAX); on a CUDA tensor they launch the kernels of
`csrc/kron_packed.cu` or raise: the apply is one launch (an x-march,
on the chunk `apply_plan` picks once per shape), the solve three (the x
transform, the four y/z transforms of each x-slab in shared memory, the
x transform back with the Dirichlet epilogue) through one padded scratch
batch. The kernels are built with ``nvcc`` for ``sm_90a`` at first use
into ``build/kernels/`` (`ops.cuda_build`) and bound through a plain C
interface with `ctypes`. `LAUNCHES` counts the calls of each entry point.

`kron_mats` and `fdm_mats` check the fixed operands once and lay them
out for the kernels (`band_rows`, `kmajor`, `fdm_layout`); a call checks
only its batch.

The factors are built as the JAX package builds them: from the float32
`KronLaplacian`'s ``Ks``/``ms`` converted to float64 (`_embed_ends` /
`_fdm_embedded` for the FDM), so a converted JAX state
(`utils.convert.packed_state_from_numpy`) and a mesh-built one agree.

Kappa is a scalar, a per-axis tuple or a constant diagonal tensor
(`resolve_kappa_axes`); graded spacing, mixed Dirichlet/Neumann faces and
Robin ends ride the per-axis factors, as in the JAX package. Not ported:
``precision="high"`` (bf16x3, raises NotImplementedError) and the TPU
knob ``interpret`` (it keeps its trailing slot in the four classes and
takes ``False`` only).
"""

import ctypes
from pathlib import Path

import numpy as np
import torch

from .cuda_build import build_and_load
from .cuda_build import find_nvcc as _find_nvcc
from .cuda_build import on_device as _on_device
from .cuda_build import ptr as _ptr
from .cuda_build import stream_of
from .kron_blocked import _check_precision, _tpu_knob
from .transfer import _sms

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "kron_packed.cu"

# Calls of each entry point on CUDA tensors since the last reset, one per
# call (an apply is one kernel launch, a solve three).
LAUNCHES = {"packed_apply": 0, "packed_fdm": 0}

# The loaded library, the compiler's output of the build that made it, and
# the extents it is compiled for (max NX and NY, max NZ, max B, the widest
# band the apply march holds in registers).
_lib = None
BUILD_LOG = ""
_LIMITS = None

# The apply march (csrc/kron_packed.cu): threads per block, and what a
# step over a halo plane costs against an output plane (it loads and
# converts the plane but sums nothing), the plan's estimate.
APPLY_THREADS = 512
HALO_STEP_COST = 0.3
# Launch plans by (B, NX, NY, NZ, band, SMs, resident blocks per SM), and
# resident march blocks per SM by (device, band, NZ).
_PLANS = {}
_RESIDENT = {}

KRON_KEYS = ("Ktx", "Kty", "Ktz", "sxy", "sz", "bc")
FDM_KEYS = ("Vxt", "Vx", "Vyt", "Vy", "Vzt", "Vz", "dinv", "bc")
# The operands each kernel call passes, in the C entry points' order.
KRON_FIXED = ("bcq", "sxy", "sz", "Kxb", "Kyb", "Kzb")
FDM_FIXED = ("bcp", "Lxf", "Lxb", "Lyf", "Lyb", "Rzf", "Rzb", "dinvp")


def _round_up(v, m):
    return ((v + m - 1) // m) * m


# --- host setup ---------------------------------------------------------------

def _embed_ends(V, ends):
    """Free-node matrix -> full-size, zero rows/cols at Dirichlet ends."""
    n = V.shape[0]
    lo, hi = int(ends[0]), int(ends[1])
    M = np.zeros((n + lo + hi, n + lo + hi), dtype=V.dtype)
    M[lo:lo + n, lo:lo + n] = V
    return M


def _fdm_embedded(mesh, P, kappa, sigma, who):
    """Boundary-embedded per-axis FDM eigen-data ``(Vs, dinv3)`` (float64):
    zero rows/cols at Dirichlet slots and the eigenvalue-sum inverse zeroed
    off the free set."""
    from ..fem.assembly import resolve_kappa_axes
    from ..solvers.fdm import _axis_eig
    from .kron import robin_axis_ends

    faces = getattr(mesh, "dirichlet_faces", ((True, True),) * 3)
    kx, ky, kz = resolve_kappa_axes(mesh, kappa)
    Vs, lams, frees = [], [], []
    for a, (nc_a, h_a, ends, k_a) in enumerate(
            zip(mesh.nc, mesh.h_cells, faces, (kx, ky, kz))):
        V, lam = _axis_eig(nc_a, P, h_a, ends=ends,
                           robin=robin_axis_ends(mesh, a, 1.0 / k_a))
        n = nc_a * P + 1
        lam_e = np.zeros(n)
        free = np.zeros(n, dtype=bool)
        lo = int(ends[0])
        lam_e[lo:lo + lam.size] = lam
        free[lo:lo + lam.size] = True
        Vs.append(_embed_ends(V, ends))
        lams.append(lam_e)
        frees.append(free)

    lx, ly, lz = lams
    d3 = (kx * lx[:, None, None] + ky * ly[None, :, None]
          + kz * lz[None, None, :]) + float(sigma)
    free3 = (frees[0][:, None, None] & frees[1][None, :, None]
             & frees[2][None, None, :])
    if free3.any() and d3[free3].min() <= 1e-14 * max(
            1.0, float(abs(d3[free3]).max())):
        raise ValueError(
            f"{who}: singular operator (no Dirichlet face and "
            "sigma=0 leaves the constant nullspace)"
        )
    dinv3 = np.where(free3, 1.0 / np.where(free3, d3, 1.0), 0.0)
    return Vs, dinv3


def _band(*mats):
    """The largest ``|i - j|`` of a nonzero entry over ``mats``."""
    band = 0
    for M in mats:
        i, j = np.nonzero(np.asarray(M))
        if i.size:
            band = max(band, int(np.abs(i - j).max()))
    return band


def band_pad(band):
    """The length of a band row: ``2 band + 1`` rounded up to whole
    float4s."""
    return _round_up(2 * int(band) + 1, 4)


def band_rows(K, band):
    """The band of the square ``K`` as float32 rows ``(n, band_pad(band))``:
    row ``a`` holds ``K[a, a - band + d]`` for ``d <= 2 band``, zero
    outside the matrix and in the padding."""
    K = np.asarray(K, np.float32)
    n = K.shape[0]
    out = np.zeros((n, band_pad(band)), np.float32)
    a = np.arange(n)
    for d in range(2 * band + 1):
        c = a - band + d
        ok = (c >= 0) & (c < n)
        out[a[ok], d] = K[a[ok], c[ok]]
    return out


def kmajor(M, rows, cols):
    """``M^T`` as a float32 ``(rows, cols)`` array, zero-padded: row ``k``
    holds ``M[:, k]``, the layout the FDM kernels' products stage."""
    Mt = np.asarray(M, np.float32).T
    out = np.zeros((rows, cols), np.float32)
    out[:Mt.shape[0], :Mt.shape[1]] = Mt
    return out


def fdm_layout(shape):
    """``(NXp, NYp, NZp)``: the extents rounded up to whole float4s. The
    FDM's scratch batch is ``(B, NX, NY, NZp)``."""
    return tuple(_round_up(int(n), 4) for n in shape)


def _expect(arrays, shapes, who):
    """Raise ValueError unless each array has its shape in ``shapes``."""
    for k, want in shapes.items():
        got = tuple(np.shape(arrays[k]))
        if got != tuple(want):
            raise ValueError(f"{who}: {k} has shape {got}, expected "
                             f"{tuple(want)}")


def kron_mats(Ktx, Kty, Ktz, sxy, sz, bc, *, device):
    """The apply's operands as float32 tensors (``bc`` bool) on ``device``:
    ``Ktx``/``Kty``/``Ktz`` the symmetrized per-axis stiffness (``y = Kt w``
    along the axis), ``sxy[(NX, NY)]`` and ``sz[(NZ,)]`` the separable
    sqrt-mass scale, ``bc[(NX, NY, NZ)]`` the Dirichlet marker; ``band``
    is the half-bandwidth of the three matrices, and ``Kxb``/``Kyb``/
    ``Kzb`` their band rows (`band_rows`) and ``bcq`` the marker as uint8
    padded to whole 16-byte rows along z, the kernel's layout. Raises
    ValueError on operands whose shapes disagree."""
    NX, NY, NZ = _lattice_of(bc, "kron_mats")
    arrays = dict(Ktx=Ktx, Kty=Kty, Ktz=Ktz, sxy=sxy, sz=sz)
    _expect(arrays, dict(Ktx=(NX, NX), Kty=(NY, NY), Ktz=(NZ, NZ),
                         sxy=(NX, NY), sz=(NZ,)), "kron_mats")
    band = _band(Ktx, Kty, Ktz)
    out = _f32(dict(arrays, Kxb=band_rows(Ktx, band),
                    Kyb=band_rows(Kty, band), Kzb=band_rows(Ktz, band)),
               bc, device)
    bcq = np.zeros((NX, NY, _round_up(NZ, 16)), np.uint8)
    bcq[..., :NZ] = np.asarray(bc, bool)
    out["bcq"] = torch.from_numpy(bcq).to(device)
    out["band"] = band
    return out


def fdm_mats(Vxt, Vx, Vyt, Vy, Vzt, Vz, dinv, bc, *, device):
    """The direct solve's operands as float32 tensors (``bc`` bool): the
    embedded eigenvector matrices (forward ``V*t``, backward ``V*``, each
    contracting as ``y = V w`` along its axis), ``dinv[(NX, NY, NZ)]``
    and the Dirichlet marker; and the kernels' layouts of them: ``Lxf``,
    ``Lxb`` ``(NX, NXp)``, ``Lyf``, ``Lyb`` ``(NY, NYp)``, ``Rzf``,
    ``Rzb`` ``(NZp, NZp)`` the k-major transposes (`kmajor`) of ``Vxt``,
    ``Vx``, ``Vyt``, ``Vy``, ``Vzt``, ``Vz``, and ``dinvp`` ``dinv``
    zero-padded to ``(NX, NY, NZp)`` (`fdm_layout`), ``bcp`` the marker
    as uint8 padded the same way. Raises ValueError on operands whose
    shapes disagree."""
    NX, NY, NZ = _lattice_of(bc, "fdm_mats")
    arrays = dict(Vxt=Vxt, Vx=Vx, Vyt=Vyt, Vy=Vy, Vzt=Vzt, Vz=Vz, dinv=dinv)
    _expect(arrays, dict(Vxt=(NX, NX), Vx=(NX, NX), Vyt=(NY, NY),
                         Vy=(NY, NY), Vzt=(NZ, NZ), Vz=(NZ, NZ),
                         dinv=(NX, NY, NZ)), "fdm_mats")
    NXp, NYp, NZp = fdm_layout((NX, NY, NZ))
    dinvp = np.zeros((NX, NY, NZp), np.float32)
    dinvp[..., :NZ] = np.asarray(dinv, np.float32)
    bcp = np.zeros((NX, NY, NZp), np.uint8)
    bcp[..., :NZ] = np.asarray(bc, bool)
    out = _f32(dict(arrays, Lxf=kmajor(Vxt, NX, NXp),
                    Lxb=kmajor(Vx, NX, NXp), Lyf=kmajor(Vyt, NY, NYp),
                    Lyb=kmajor(Vy, NY, NYp), Rzf=kmajor(Vzt, NZp, NZp),
                    Rzb=kmajor(Vz, NZp, NZp), dinvp=dinvp), bc, device)
    out["bcp"] = torch.from_numpy(bcp).to(device)
    return out


def _lattice_of(bc, who):
    """The lattice ``(NX, NY, NZ)`` of the marker ``bc``."""
    shape = tuple(np.shape(bc))
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"{who}: bc must be a (NX, NY, NZ) marker, got "
                         f"shape {shape}")
    return shape


def _f32(arrays, bc, device):
    """Contiguous float32 copies of ``arrays`` and the bool marker ``bc``
    on ``device``."""
    out = {k: torch.from_numpy(np.array(v, np.float32, order="C")).to(device)
           for k, v in arrays.items()}
    out["bc"] = torch.from_numpy(np.array(bc, bool)).to(device)
    return out


def _symmetrized_factors(base, P):
    """``(Kts, ss)``: float64 symmetrized stiffness and sqrt-masses from the
    float32 `KronLaplacian` ``base``, as the JAX package builds them; the
    kernels sum over the band, so an entry outside ``|i-j| <= P`` raises."""
    ss = [np.sqrt(m.cpu().numpy().astype(np.float64)) for m in base.ms]
    Kts = [K.cpu().numpy().astype(np.float64) / s[:, None] / s[None, :]
           for K, s in zip(base.Ks, ss)]
    if _band(*Kts) > P:
        raise ValueError(
            f"the symmetrized stiffness has entries outside the band "
            f"|i-j| <= {P}; the packed kernels sum over the band only")
    return Kts, ss


# --- plain torch versions -----------------------------------------------------

def plain_packed_apply(X, m, sigma=0.0):
    """``A x`` per right-hand side of a ``(B, NX, NY, NZ)`` batch (the port
    of `_emu_apply`): torch einsums in the mats' dtype."""
    s3 = m["sxy"][:, :, None] * m["sz"]
    w = X.masked_fill(m["bc"], 0.0) * s3
    t = torch.einsum("ax,bxyz->bayz", m["Ktx"], w)
    t = t + torch.einsum("cy,bxyz->bxcz", m["Kty"], w)
    t = t + torch.einsum("cz,bxyz->bxyc", m["Ktz"], w)
    if sigma:
        t = t + sigma * w
    return torch.where(m["bc"], X, t * s3)


def plain_packed_fdm(Bv, m):
    """``A^{-1} b`` per right-hand side of a ``(B, NX, NY, NZ)`` batch, bc
    rows passed through (the port of `_emu_fdm`)."""
    t = torch.einsum("ax,bxyz->bayz", m["Vxt"], Bv)
    t = torch.einsum("cy,bxyz->bxcz", m["Vyt"], t)
    t = torch.einsum("cz,bxyz->bxyc", m["Vzt"], t)
    t = t * m["dinv"]
    t = torch.einsum("cz,bxyz->bxyc", m["Vz"], t)
    t = torch.einsum("cy,bxyz->bxcz", m["Vy"], t)
    u = torch.einsum("ax,bxyz->bayz", m["Vx"], t)
    return torch.where(m["bc"], Bv, u)


# --- CUDA kernels -------------------------------------------------------------

def load_kernels():
    """Build (once per source hash) and load the kernel library.

    Raises RuntimeError when there is no CUDA device, no ``nvcc`` or the
    build fails; never returns a stand-in.
    """
    global _lib, BUILD_LOG, _LIMITS
    if _lib is not None:
        return _lib
    lib, BUILD_LOG = build_and_load(_SRC, "kron_packed", _find_nvcc)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.packed_apply_launch.argtypes = [vp] * 8 + [ci] * 6 + [cf, vp]
    lib.packed_apply_launch.restype = ci
    lib.packed_fdm_launch.argtypes = [vp] * 11 + [ci] * 4 + [vp]
    lib.packed_fdm_launch.restype = ci
    lib.packed_fdm_plan.argtypes = [ci] * 4 + [ctypes.POINTER(
        ctypes.c_longlong)]
    lib.packed_fdm_plan.restype = ci
    lib.packed_apply_resident.argtypes = [ci] * 3
    lib.packed_apply_resident.restype = ci
    limits = []
    for name in ("packed_max_n", "packed_max_nz", "packed_max_batch",
                 "packed_max_band_march"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ci
        limits.append(getattr(lib, name)())
    _LIMITS = tuple(limits)
    _lib = lib
    return lib


def apply_plan(B, shape, band, sms, resident=1):
    """The apply march's launch shape on a card of ``sms`` SMs holding
    ``resident`` march blocks each: ``{"lanes", "rows", "chunk", "grid"}``.
    A block of `APPLY_THREADS` threads, two z values each, owns a tile of
    ``rows`` y-rows and ``lanes`` z values (32 or 64, the z extent
    rounded up), marching over ``chunk`` x-planes plus a ``band``-plane
    halo each side. The chunk minimises waves x steps per block (a halo
    step weighs `HALO_STEP_COST`), the longer chunk on a tie: short
    chunks fill the card at B = 1, one whole-x chunk reads the halo once
    at large B."""
    key = (B, *shape, band, sms, resident)
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    NX, NY, NZ = shape
    lanes = 32 if NZ <= 32 else 64
    rows = APPLY_THREADS // (lanes // 2)
    tiles = -(-NY // rows)
    best = None
    for nch in range(1, NX + 1):
        chunk = -(-NX // nch)
        if -(-NX // chunk) != nch:
            continue
        waves = -(-(tiles * nch * B) // (sms * resident))
        cost = waves * (chunk + HALO_STEP_COST * 2 * band)
        if best is None or cost < best[0]:
            best = (cost, chunk, nch)
    _, chunk, nch = best
    plan = _PLANS[key] = {"lanes": lanes, "rows": rows, "chunk": chunk,
                          "grid": (tiles, nch, B)}
    return plan


def _resident(device, band, NZ, NX):
    """Resident apply-march blocks per SM of ``device`` (the CUDA occupancy
    API, at the longest chunk's shared memory), read once."""
    key = (device.index, band, NZ)
    n = _RESIDENT.get(key)
    if n is None:
        n = load_kernels().packed_apply_resident(band, NZ, NX)
        if n <= 0:
            raise RuntimeError(f"packed_apply: the march at band {band} "
                               f"does not fit an SM (CUDA error {-n})")
        _RESIDENT[key] = n
    return n


def fdm_launch_plan(B, shape):
    """The solve's launch plan on the current card (`csrc/kron_packed.cu`
    ``fdm_plan``): the persistent grid, tile columns and shared bytes of
    each x pass, the slab pass's grid, shared bytes, slab buffers and
    whether two blocks share each slab."""
    info = (ctypes.c_longlong * 10)()
    rc = load_kernels().packed_fdm_plan(B, *shape, info)
    if rc != 0:
        raise RuntimeError(f"packed_fdm plan failed: CUDA error {rc}")
    return dict(zip(("x_fwd_blocks", "x_fwd_columns", "x_bwd_blocks",
                     "x_bwd_columns", "slab_blocks", "slab_buffers",
                     "x_fwd_smem", "slab_smem", "x_bwd_smem", "slab_pairs"),
                    list(info)))


def _fixed(m, keys):
    """The ctypes pointers of the fixed operands ``keys`` of ``m``, made
    once per operand dict."""
    ptrs = m.get("_ptrs")
    if ptrs is None or ptrs[0] != keys:
        ptrs = m["_ptrs"] = (keys, tuple(_ptr(m[k]) for k in keys))
    return ptrs[1]


def _check_batch(X, m):
    """Check a kernel call's batch against its operands ``m`` (checked
    when `kron_mats` / `fdm_mats` built them); returns ``(lib, B)``."""
    if X.device.type != "cuda":
        raise ValueError(
            f"the kron_packed kernels run on CUDA tensors, got {X.device}")
    if X.dtype != torch.float32:
        raise TypeError(f"the batch must be torch.float32, got {X.dtype}")
    bc = m["bc"]
    if X.ndim != 4 or X.shape[1:] != bc.shape:
        raise ValueError("the batch must be (B, "
                         f"{', '.join(map(str, bc.shape))}), got "
                         f"{tuple(X.shape)}")
    if X.device != bc.device:
        raise ValueError(f"the batch is on {X.device}, its operands on "
                         f"{bc.device}")
    if not X.is_contiguous():
        raise ValueError("the batch must be contiguous")
    lib = load_kernels()
    max_n, max_nz, max_b, _ = _LIMITS
    B, NX, NY, NZ = X.shape
    if not (max(NX, NY) <= max_n and NZ <= max_nz and 1 <= B <= max_b):
        raise ValueError(
            f"batch {tuple(X.shape)} is outside what the kron_packed kernels "
            f"are compiled for (NX, NY <= {max_n}, NZ <= {max_nz}, "
            f"1 <= B <= {max_b})")
    return lib, B


def launch_packed_apply(X, m, sigma=0.0):
    """Launch the apply kernel on a CUDA ``(B, NX, NY, NZ)`` batch."""
    lib, B = _check_batch(X, m)
    shape, band = tuple(X.shape[1:]), m["band"]
    chunk = 1
    if band <= _LIMITS[3]:
        chunk = apply_plan(B, shape, band, _sms(X.device),
                           _resident(X.device, band, shape[2],
                                     shape[0]))["chunk"]
    out = torch.empty_like(X)
    with _on_device(X):
        rc = lib.packed_apply_launch(
            _ptr(X), *_fixed(m, KRON_FIXED), _ptr(out), B, *shape, band,
            chunk, float(sigma), stream_of(X))
    if rc != 0:
        raise RuntimeError(f"packed_apply launch failed: CUDA error {rc}")
    LAUNCHES["packed_apply"] += 1
    return out


def launch_packed_fdm(Bv, m):
    """Launch the direct-solve kernels on a CUDA ``(B, NX, NY, NZ)``
    batch."""
    lib, B = _check_batch(Bv, m)
    NX, NY, NZ = Bv.shape[1:]
    t = torch.empty((B, NX, NY, _round_up(NZ, 4)), dtype=torch.float32,
                    device=Bv.device)
    out = torch.empty_like(Bv)
    with _on_device(Bv):
        rc = lib.packed_fdm_launch(
            _ptr(Bv), *_fixed(m, FDM_FIXED), _ptr(t), _ptr(out), B, NX, NY,
            NZ, stream_of(Bv))
    if rc != 0:
        raise RuntimeError(f"packed_fdm launch failed: CUDA error {rc}")
    LAUNCHES["packed_fdm"] += 1
    return out


def packed_apply(X, m, sigma=0.0):
    """``A x`` per right-hand side of a ``(B, NX, NY, NZ)`` batch: the plain
    torch version on a CPU tensor, the CUDA kernels (float32) on a CUDA
    tensor, else raise."""
    if X.device.type == "cpu":
        return plain_packed_apply(X, m, sigma)
    return launch_packed_apply(X, m, sigma)


def packed_fdm(Bv, m):
    """``A^{-1} b`` per right-hand side (bc rows pass through): the plain
    torch version on a CPU tensor, the CUDA kernels on a CUDA tensor."""
    if Bv.device.type == "cpu":
        return plain_packed_fdm(Bv, m)
    return launch_packed_fdm(Bv, m)


# --- the four classes ---------------------------------------------------------

class _Layout:
    """The unpadded working layout shared by the four classes: ``lead +
    (NX, NY, NZ)`` float32 with ``lead = (B,)`` for the batch classes and
    ``()`` for the single ones."""

    def _init_layout(self, mesh, P, lead, device):
        NX, NY, NZ = mesh.lattice_shape(P)
        if NZ > 64:
            raise ValueError(
                f"{type(self).__name__} targets small lattices (NZ <= 64, "
                f"got {NZ}); at larger N use the plain paths"
            )
        self.P = int(P)
        self.mesh = mesh
        self.ndofs = mesh.num_dofs(P)
        self.shape = (NX, NY, NZ)
        self.device = torch.device(device)
        self._lead = lead

    def pack(self, U):
        """``(B, ndofs)`` or ``(B, NX, NY, NZ)`` (``(ndofs,)`` or
        ``(NX, NY, NZ)`` for the single classes) -> the working layout: a
        contiguous float32 tensor on the device."""
        U = torch.as_tensor(U).to(device=self.device, dtype=torch.float32)
        return U.reshape(self._lead + self.shape).contiguous()

    def unpack(self, PT):
        """The working layout -> ``(B, NX, NY, NZ)`` (``(NX, NY, NZ)``):
        the same tensor."""
        return PT.reshape(self._lead + self.shape)

    def _batched(self, fn, PT, *args):
        """``fn`` on the working layout seen as a ``(B, NX, NY, NZ)``
        batch."""
        return fn(PT.reshape((-1,) + self.shape), self.mats,
                  *args).reshape(PT.shape)


class _Kron(_Layout):
    def _kron_setup(self, kappa, precision, sigma):
        from .kron import KronLaplacian

        base = KronLaplacian(self.mesh, self.P, kappa=kappa,
                             dtype=torch.float32, sigma=sigma,
                             device=self.device)
        self.precision = precision
        self.sigma = float(sigma)
        self.diag = base.diag
        self.diag_inv = base.diag_inv
        Kts, ss = _symmetrized_factors(base, self.P)
        self.mats = kron_mats(
            Kts[0], Kts[1], Kts[2], np.outer(ss[0], ss[1]), ss[2],
            np.asarray(base.bc_marker.cpu()).reshape(self.shape),
            device=self.device)

    def apply_packed(self, PT):
        return self._batched(packed_apply, PT, self.sigma)

    def __call__(self, U):
        """The apply on a flat or lattice-shaped (batch of) vector(s)."""
        return self.apply_packed(self.pack(U)).reshape(
            tuple(torch.as_tensor(U).shape))


class _FDM(_Layout):
    def _init_layout(self, mesh, P, lead, device):
        from ..fem.mesh import require_axis_aligned

        require_axis_aligned(mesh, type(self).__name__)
        super()._init_layout(mesh, P, lead, device)

    def _fdm_setup(self, kappa, sigma):
        Vs, dinv3 = _fdm_embedded(self.mesh, self.P, kappa, sigma,
                                  type(self).__name__)
        bc = np.asarray(self.mesh.boundary_dof_marker(self.P))
        self.mats = fdm_mats(Vs[0].T, Vs[0], Vs[1].T, Vs[1], Vs[2].T, Vs[2],
                             dinv3, bc.reshape(self.shape),
                             device=self.device)

    def solve_packed(self, PT):
        return self._batched(packed_fdm, PT)

    def solve(self, U):
        """The direct solve on a flat or lattice-shaped (batch of)
        vector(s); ``u[bc] = b[bc]``."""
        return self.solve_packed(self.pack(U)).reshape(
            tuple(torch.as_tensor(U).shape))


class PackedKronBatch(_Kron):
    """Batched Kronecker operator for small lattices (float32).

    ``__call__`` takes and returns ``(B, ndofs)`` or ``(B, NX, NY, NZ)``;
    `pack` / `apply_packed` / `unpack` keep the batch in its working
    layout across a whole solve. Same operator contract per right-hand
    side as `ops.kron.KronLaplacian` (per-axis kappa, sigma, mixed faces,
    graded spacing).
    """

    def __init__(self, mesh, P, kappa=2.0, B=8, precision="highest",
                 sigma=0.0, interpret=False, *, device):
        _check_precision(precision)
        _tpu_knob("interpret", interpret, False)
        self._init_layout(mesh, P, (-1,), device)
        self.B = int(B)
        self._kron_setup(kappa, precision, sigma)


class PackedFDMBatch(_FDM):
    """Batched FDM direct solve for small lattices (float32): per
    right-hand side the solver contract of
    `solvers.fdm.FastDiagonalizationSolver` (per-axis kappa, sigma shift,
    mixed Dirichlet/Neumann faces); ``u[bc] = b[bc]``."""

    def __init__(self, mesh, P, kappa=2.0, B=8, sigma=0.0, interpret=False,
                 *, device):
        _tpu_knob("interpret", interpret, False)
        self._init_layout(mesh, P, (-1,), device)
        self.B = int(B)
        self._fdm_setup(kappa, sigma)


def _check_slab(P, shape):
    """The JAX single-RHS apply packs ``g = 128 // Zp`` x-slabs of height
    ``XS = align8(ceil(NX / g))`` per lane tile and needs ``XS`` to hold
    the 8-aligned band; the port refuses the same lattices, so both
    packages accept the same inputs."""
    NX, _, NZ = shape
    g = 128 // (32 if NZ <= 32 else 64)
    XS = _round_up(-(-NX // g), 8)
    Pb = _round_up(int(P), 8)
    if XS < Pb:
        raise ValueError(
            f"PackedKronSingle needs slab height >= the 8-aligned band "
            f"({Pb}); got XS={XS} for NX={NX}, g={g} — lattice too small "
            "for the reference's x-slab packing")


class PackedKronSingle(_Kron):
    """Single-RHS Kronecker apply for small lattices (float32): the function
    of `PackedKronBatch` at B = 1, on the same factors. ``__call__`` takes
    ``(ndofs,)`` or ``(NX, NY, NZ)``."""

    def __init__(self, mesh, P, kappa=2.0, precision="highest", sigma=0.0,
                 interpret=False, *, device):
        _check_precision(precision)
        _tpu_knob("interpret", interpret, False)
        self._init_layout(mesh, P, (), device)
        _check_slab(P, self.shape)
        self._kron_setup(kappa, precision, sigma)


class PackedFDMSingle(_FDM):
    """Single-RHS FDM direct solve for small lattices (float32): the
    function of `PackedFDMBatch` at B = 1, on the same factors."""

    def __init__(self, mesh, P, kappa=2.0, sigma=0.0, interpret=False, *,
                 device):
        _tpu_knob("interpret", interpret, False)
        self._init_layout(mesh, P, (), device)
        self._fdm_setup(kappa, sigma)
