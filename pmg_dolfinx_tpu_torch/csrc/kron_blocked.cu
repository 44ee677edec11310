// Hand-written Hopper (sm_90a) kernels for the blocked Kronecker-sum apply.
//
// Replaces the Pallas kernels of pmg_dolfinx_tpu/ops/pallas_kron_blocked.py:
//   kron_t1_m               <- _kernel_t1_m       (x-contraction, separable bc mask)
//   kron_t23_m<false>       <- _kernel_t23_m      (y/z-contractions + bc epilogue)
//   kron_t23_m<true>        <- _kernel_t23_res_m  (the same, fused  r - A v)
//   kron_t1                 <- _kernel_t1         (x-contraction, full bc array)
//   kron_t23<kApply>        <- _kernel_t23        (y/z-contractions, full bc array)
//   kron_t23<kResidual>     <- _kernel_t23_res    (the same, fused  r - A v)
//   kron_t23<kCheb>         <- _kernel_t23_cheb   (the same, fused Chebyshev-4 step)
//   kron_t23_m<R, true>     <- _kernel_t23_grid_m (kernel 2 on a device-grid shard)
//   kron_t23<kApply|kResidual, true> <- _kernel_t23_grid (the same, full bc array)
//
// Operator (symmetrized form, see ops/kron_blocked.py:symmetrized_mats):
//   t1'      = Ktx-contraction of (x * my_j * sxzm)           [kernel 1]
//   acc      = sy_j t1' + sx_i (Kty w^ + w^ KtzT) [+ sigma sx_i w^]
//              with w^ = x * mx_i * s23m                       [kernel 2]
//   y        = acc * sx_i * s23m
//   out      = x (1 - mx_i my_j mz_k) + y mx_i   (Dirichlet rows copy x)
//
// The full-bc kernels take the Dirichlet marker as a byte lattice (a
// torch.bool tensor is one byte per entry; no conversion to int32) and
// the unmasked scale planes sxz = sx (x) sz, s23 = sy (x) sz:
//   t1'      = Ktx-contraction of (where(bc, 0, x) * sxz)     [kron_t1]
//   w^       = where(bc, 0, v) * s23 ; acc, y as above        [kron_t23]
//   Av       = where(bc, v, y)
//   kApply: out = Av ; kResidual: out = r - Av ;
//   kCheb:  r' = r - Av ; x' = x + gamma v ; z' = a v + b dinv r'
// with (gamma, a, b) = (0, 0, 4/(3 lmax)) on the init step (k = 0, v = x)
// and (1, (2k-1)/(2k+3), (8k+4)/((2k+3) lmax)) on loop step k (v = z),
// computed in float32 from the device scalar lmax in every thread, so a
// smoother makes no host read. kCheb reads six lattices (v, bc, t1', x,
// r, dinv) and writes three (r', x', z'); v is read through the y/z halo
// by neighbouring blocks, so no output may alias an input: the wrapper
// allocates every output.
//
// What bounds it on this card. Kt_a is the assembled 1D GLL stiffness
// scaled symmetrically, so it is BANDED with half-width P (checked in
// float64 at setup; the wrapper passes `band`). The TPU kernels run dense
// per-slab MXU dots (~759 FMAs per output at p=6, ~24.6 GFLOP per apply at
// 16.2M dofs); over the band the pair does 3*(2P+1) = 39 FMAs per output,
// which leaves it memory-bound: ~5 lattice passes per apply (x read by each
// kernel, t1' written then read, y written; the residual adds r). A dense
// x-plane at 253^2 f32 (256,036 bytes) would not fit the 227 KB of shared
// memory a block may use, and it is not needed: each output only reads its
// 2P+1 band neighbours per axis. The full-bc kernels add a 1-byte marker
// read per kernel; the fused Chebyshev step moves ~8.25 lattice passes
// (six reads, three writes) where the unfused smoother step moves the
// pair's ~5 plus 10-15 passes of elementwise updates.
//
// Design. A block owns a 32 (z) x 32 (x or y) tile of outputs, 256 threads
// of 32 x 8, each thread 4 outputs along the tile's second axis; z is
// fastest across a warp, so every global access coalesces. The block
// stages its masked, scaled input tile WITH a halo of `band` planes in
// shared memory, and the band of each 1D matrix its rows need, so the
// 2P+1 neighbour reads per axis come from shared memory instead of 26
// L1/L2 loads per output: global traffic per output drops to about
// (32+2P)/32 input reads plus the output. Terms outside the lattice are
// staged as zeros, so every thread runs the same 2P+1-term loops. Sums run
// in true f32 FMA on the CUDA cores (the JAX package's precision="highest"
// contract), in ascending neighbour order; only the order of addition
// differs from a dense product.
//
// Device-grid shards (GRID = true). On a shard of a 2D/3D device grid the
// y/z contractions of the boundary planes miss the neighbour shard's
// cells; the caller computes those partial sums from x, exchanges them,
// and passes what it received as two nullable correction arrays:
//   cy (NX, 2, NZ): t2 partials for the first (0) and last (1) y-plane,
//   cz (NX, NY, 2): t3 partials for the first and last z-plane.
// Each thread adds them to its accumulator after the sigma term and before
// the final scaling, as the TPU kernel does:
//   acc += sx_i (cy[i,0,k] [j == 0] + cy[i,1,k] [j == NY-1])
//   acc += sx_i (cz[i,j,0] [k == 0] + cz[i,j,1] [k == NZ-1])
// so the shared output factor sx_i s23 completes the neighbour terms. The
// Dirichlet epilogue overwrites bc rows afterwards, so the corrections need
// no mask. GRID is a template flag, so kernels #2, #3 and #5-#7 compile
// exactly as before; a null cy or cz (an unsharded axis) is a uniform
// branch, and only boundary-plane threads load a correction. The launchers
// of kernels 2 and #5/#6 take cy / cz and pick the GRID instantiation when
// either is given.
//
// Every C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (or cudaErrorInvalidValue for a band the
// tiles cannot hold) so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTK = 32;           // tile extent along z (one warp)
constexpr int kTR = 8;            // thread rows per block
constexpr int kRPT = 4;           // outputs per thread along the tile rows
constexpr int kRows = kTR * kRPT; // tile extent along x (kernel 1) / y (2)
constexpr int kMaxBand = 16;          // keeps kernel 2's tiles under 48 KB

// The neighbour-shard corrections of a device-grid shard (see the head of
// this file): what the thread at (i, j, k) adds to its accumulator.
__device__ __forceinline__ float grid_corrections(
    float acc, float sxi, const float* __restrict__ cy,
    const float* __restrict__ cz, int i, int j, int k, int NY, int NZ) {
  if (cy != nullptr && (j == 0 || j == NY - 1)) {
    const float* c = cy + (int64_t)i * 2 * NZ + k;
    acc = acc + sxi * ((j == 0 ? c[0] : 0.f) + (j == NY - 1 ? c[NZ] : 0.f));
  }
  if (cz != nullptr && (k == 0 || k == NZ - 1)) {
    const float* c = cz + ((int64_t)i * NY + j) * 2;
    acc = acc + sxi * ((k == 0 ? c[0] : 0.f) + (k == NZ - 1 ? c[1] : 0.f));
  }
  return acc;
}

__global__ void __launch_bounds__(kTK * kTR)
kron_t1_m(const float* __restrict__ x, const float* __restrict__ myb,
          const float* __restrict__ Ktx, const float* __restrict__ sxzm,
          float* __restrict__ out, int NX, int NY, int NZ, int band) {
  extern __shared__ float smem[];
  const int H = kRows + 2 * band;     // staged x-planes (tile + halo)
  const int D = 2 * band + 1;         // band width
  float* sw = smem;                   // [H][kTK]  w = x * my_j * sxzm
  float* sK = smem + H * kTK;         // [D][kRows] Ktx[a, a - band + d]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTK + tx;
  const int k0 = blockIdx.x * kTK, a0 = blockIdx.y * kRows, j = blockIdx.z;
  const int k = k0 + tx;
  const int64_t plane = (int64_t)NY * NZ;
  const float myj = myb[j];

  for (int r = ty; r < H; r += kTR) {
    const int a = a0 - band + r;
    float v = 0.f;
    if (a >= 0 && a < NX && k < NZ)
      v = x[a * plane + (int64_t)j * NZ + k] * (myj * sxzm[(int64_t)a * NZ + k]);
    sw[r * kTK + tx] = v;
  }
  for (int t = tid; t < D * kRows; t += kTK * kTR) {
    const int d = t / kRows, r = t % kRows;
    const int a = a0 + r, xi = a - band + d;
    sK[t] = (a < NX && xi >= 0 && xi < NX) ? Ktx[(int64_t)a * NX + xi] : 0.f;
  }
  __syncthreads();
  if (k >= NZ) return;
  for (int q = 0; q < kRPT; ++q) {
    const int r = ty + q * kTR;
    const int a = a0 + r;
    if (a >= NX) break;
    float acc = 0.f;
    for (int d = 0; d < D; ++d)
      acc = fmaf(sK[d * kRows + r], sw[(r + d) * kTK + tx], acc);
    out[a * plane + (int64_t)j * NZ + k] = acc;
  }
}

template <bool RESIDUAL, bool GRID>
__global__ void __launch_bounds__(kTK * kTR)
kron_t23_m(const float* __restrict__ x, const float* __restrict__ mx2,
           const float* __restrict__ t1, const float* __restrict__ Kty,
           const float* __restrict__ KtzT, const float* __restrict__ sx2d,
           const float* __restrict__ sycol, const float* __restrict__ s23m,
           const float* __restrict__ myb, const float* __restrict__ mzrow,
           const float* __restrict__ cy, const float* __restrict__ cz,
           const float* __restrict__ r, float* __restrict__ out,
           int NX, int NY, int NZ, int band, float sigma) {
  extern __shared__ float smem[];
  const int H = kRows + 2 * band;     // staged y-rows (tile + halo)
  const int W = kTK + 2 * band;       // staged z-columns (tile + halo)
  const int D = 2 * band + 1;
  float* sw = smem;                   // [H][W]  w^ = x * mx_i * s23m
  float* sKy = sw + H * W;            // [D][kRows] Kty[j, j - band + d]
  float* sKz = sKy + D * kRows;       // [D][kTK]  KtzT[k - band + d, k]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTK + tx;
  const int k0 = blockIdx.x * kTK, j0 = blockIdx.y * kRows, i = blockIdx.z;
  const int k = k0 + tx;
  const int64_t plane = (int64_t)NY * NZ;
  const float* xi_pl = x + (int64_t)i * plane;
  const float mxi = mx2[i], sxi = sx2d[i];

  for (int t = tid; t < H * W; t += kTK * kTR) {
    const int jj = j0 - band + t / W, kk = k0 - band + t % W;
    float v = 0.f;
    if (jj >= 0 && jj < NY && kk >= 0 && kk < NZ) {
      const int64_t o = (int64_t)jj * NZ + kk;
      v = xi_pl[o] * (mxi * s23m[o]);
    }
    sw[t] = v;
  }
  for (int t = tid; t < D * kRows; t += kTK * kTR) {
    const int d = t / kRows, rj = t % kRows;
    const int j = j0 + rj, jj = j - band + d;
    sKy[t] = (j < NY && jj >= 0 && jj < NY) ? Kty[(int64_t)j * NY + jj] : 0.f;
  }
  for (int t = tid; t < D * kTK; t += kTK * kTR) {
    const int d = t / kTK, kc = k0 + t % kTK, kk = kc - band + d;
    sKz[t] = (kc < NZ && kk >= 0 && kk < NZ) ? KtzT[(int64_t)kk * NZ + kc] : 0.f;
  }
  __syncthreads();
  if (k >= NZ) return;
  for (int q = 0; q < kRPT; ++q) {
    const int rj = ty + q * kTR;
    const int j = j0 + rj;
    if (j >= NY) break;
    float t2 = 0.f, t3 = 0.f;
    for (int d = 0; d < D; ++d)
      t2 = fmaf(sKy[d * kRows + rj], sw[(rj + d) * W + tx + band], t2);
    const float* srow = sw + (rj + band) * W + tx;
    for (int d = 0; d < D; ++d)
      t3 = fmaf(srow[d], sKz[d * kTK + tx], t3);

    const int64_t o = (int64_t)j * NZ + k;
    const int64_t idx = (int64_t)i * plane + o;
    const float xv = xi_pl[o];
    const float s = s23m[o];
    const float what = srow[band];
    float acc = sycol[j] * t1[idx] + sxi * (t2 + t3);
    if (sigma != 0.f) acc = acc + (sigma * sxi) * what;
    if (GRID) acc = grid_corrections(acc, sxi, cy, cz, i, j, k, NY, NZ);
    const float y = acc * (sxi * s);
    const float av = xv * (1.f - mxi * (myb[j] * mzrow[k])) + y * mxi;
    out[idx] = RESIDUAL ? r[idx] - av : av;
  }
}

// kron_t1_m with the full bc lattice: w = where(bc, 0, x) * sxz.
__global__ void __launch_bounds__(kTK * kTR)
kron_t1(const float* __restrict__ x, const uint8_t* __restrict__ bc,
        const float* __restrict__ Ktx, const float* __restrict__ sxz,
        float* __restrict__ out, int NX, int NY, int NZ, int band) {
  extern __shared__ float smem[];
  const int H = kRows + 2 * band;
  const int D = 2 * band + 1;
  float* sw = smem;                   // [H][kTK]  w = where(bc, 0, x) * sxz
  float* sK = smem + H * kTK;         // [D][kRows] Ktx[a, a - band + d]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTK + tx;
  const int k0 = blockIdx.x * kTK, a0 = blockIdx.y * kRows, j = blockIdx.z;
  const int k = k0 + tx;
  const int64_t plane = (int64_t)NY * NZ;

  for (int r = ty; r < H; r += kTR) {
    const int a = a0 - band + r;
    float v = 0.f;
    if (a >= 0 && a < NX && k < NZ) {
      const int64_t g = a * plane + (int64_t)j * NZ + k;
      v = bc[g] ? 0.f : x[g] * sxz[(int64_t)a * NZ + k];
    }
    sw[r * kTK + tx] = v;
  }
  for (int t = tid; t < D * kRows; t += kTK * kTR) {
    const int d = t / kRows, r = t % kRows;
    const int a = a0 + r, xi = a - band + d;
    sK[t] = (a < NX && xi >= 0 && xi < NX) ? Ktx[(int64_t)a * NX + xi] : 0.f;
  }
  __syncthreads();
  if (k >= NZ) return;
  for (int q = 0; q < kRPT; ++q) {
    const int r = ty + q * kTR;
    const int a = a0 + r;
    if (a >= NX) break;
    float acc = 0.f;
    for (int d = 0; d < D; ++d)
      acc = fmaf(sK[d * kRows + r], sw[(r + d) * kTK + tx], acc);
    out[a * plane + (int64_t)j * NZ + k] = acc;
  }
}

enum T23Mode { kApply = 0, kResidual = 1, kCheb = 2 };

// kron_t23_m with the full bc lattice and three epilogues (see the head of
// this file). Unused pointers of a mode are null.
template <int MODE, bool GRID>
__global__ void __launch_bounds__(kTK * kTR)
kron_t23(const float* __restrict__ v, const uint8_t* __restrict__ bc,
         const float* __restrict__ t1, const float* __restrict__ Kty,
         const float* __restrict__ KtzT, const float* __restrict__ sx2d,
         const float* __restrict__ sycol, const float* __restrict__ s23,
         const float* __restrict__ cy, const float* __restrict__ cz,
         const float* __restrict__ r, const float* __restrict__ x,
         const float* __restrict__ dinv, const float* __restrict__ lmax,
         int kstep, float* __restrict__ out, float* __restrict__ xo,
         float* __restrict__ zo, int NX, int NY, int NZ, int band,
         float sigma) {
  extern __shared__ float smem[];
  const int H = kRows + 2 * band;
  const int W = kTK + 2 * band;
  const int D = 2 * band + 1;
  float* sw = smem;                   // [H][W]  w^ = where(bc, 0, v) * s23
  float* sKy = sw + H * W;            // [D][kRows] Kty[j, j - band + d]
  float* sKz = sKy + D * kRows;       // [D][kTK]  KtzT[k - band + d, k]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTK + tx;
  const int k0 = blockIdx.x * kTK, j0 = blockIdx.y * kRows, i = blockIdx.z;
  const int k = k0 + tx;
  const int64_t plane = (int64_t)NY * NZ;
  const float* vi_pl = v + (int64_t)i * plane;
  const uint8_t* bci_pl = bc + (int64_t)i * plane;
  const float sxi = sx2d[i];

  for (int t = tid; t < H * W; t += kTK * kTR) {
    const int jj = j0 - band + t / W, kk = k0 - band + t % W;
    float w = 0.f;
    if (jj >= 0 && jj < NY && kk >= 0 && kk < NZ) {
      const int64_t o = (int64_t)jj * NZ + kk;
      w = bci_pl[o] ? 0.f : vi_pl[o] * s23[o];
    }
    sw[t] = w;
  }
  for (int t = tid; t < D * kRows; t += kTK * kTR) {
    const int d = t / kRows, rj = t % kRows;
    const int j = j0 + rj, jj = j - band + d;
    sKy[t] = (j < NY && jj >= 0 && jj < NY) ? Kty[(int64_t)j * NY + jj] : 0.f;
  }
  for (int t = tid; t < D * kTK; t += kTK * kTR) {
    const int d = t / kTK, kc = k0 + t % kTK, kk = kc - band + d;
    sKz[t] = (kc < NZ && kk >= 0 && kk < NZ) ? KtzT[(int64_t)kk * NZ + kc] : 0.f;
  }
  // The Chebyshev coefficients, as the JAX package computes them in f32.
  float gamma = 0.f, ca = 0.f, cb = 0.f;
  if (MODE == kCheb) {
    const float lm = *lmax;
    if (kstep == 0) {
      cb = 4.f / (3.f * lm);
    } else {
      const float kf = (float)kstep;
      gamma = 1.f;
      ca = (2.f * kf - 1.f) / (2.f * kf + 3.f);
      cb = (8.f * kf + 4.f) / ((2.f * kf + 3.f) * lm);
    }
  }
  __syncthreads();
  if (k >= NZ) return;
  for (int q = 0; q < kRPT; ++q) {
    const int rj = ty + q * kTR;
    const int j = j0 + rj;
    if (j >= NY) break;
    float t2 = 0.f, t3 = 0.f;
    for (int d = 0; d < D; ++d)
      t2 = fmaf(sKy[d * kRows + rj], sw[(rj + d) * W + tx + band], t2);
    const float* srow = sw + (rj + band) * W + tx;
    for (int d = 0; d < D; ++d)
      t3 = fmaf(srow[d], sKz[d * kTK + tx], t3);

    const int64_t o = (int64_t)j * NZ + k;
    const int64_t idx = (int64_t)i * plane + o;
    const float vv = vi_pl[o];
    const float what = srow[band];
    float acc = sycol[j] * t1[idx] + sxi * (t2 + t3);
    if (sigma != 0.f) acc = acc + (sigma * sxi) * what;
    if (GRID) acc = grid_corrections(acc, sxi, cy, cz, i, j, k, NY, NZ);
    const float y = acc * (sxi * s23[o]);
    const float av = bci_pl[o] ? vv : y;
    if (MODE == kApply) {
      out[idx] = av;
    } else if (MODE == kResidual) {
      out[idx] = r[idx] - av;
    } else {
      const float rn = r[idx] - av;
      out[idx] = rn;
      xo[idx] = x[idx] + gamma * vv;
      zo[idx] = ca * vv + cb * dinv[idx] * rn;
    }
  }
}

inline dim3 tile_grid(int NZ, int rows, int third) {
  return dim3((unsigned)((NZ + kTK - 1) / kTK),
              (unsigned)((rows + kRows - 1) / kRows), (unsigned)third);
}

// Shared memory of kernel 2 and of #5-#9: the staged tile with its halo
// and the bands of Kty and KtzT.
inline size_t t23_smem(int band) {
  return sizeof(float) * ((kRows + 2 * band) * (kTK + 2 * band) +
                          (2 * band + 1) * (kRows + kTK));
}

}  // namespace

extern "C" {

int kron_max_band() { return kMaxBand; }

int kron_t1_m_launch(const float* x, const float* myb, const float* Ktx,
                     const float* sxzm, float* out, int NX, int NY, int NZ,
                     int band, void* stream) {
  if (band < 0 || band > kMaxBand) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((kRows + 2 * band) * kTK + (2 * band + 1) * kRows);
  kron_t1_m<<<tile_grid(NZ, NX, NY), dim3(kTK, kTR), smem,
              (cudaStream_t)stream>>>(x, myb, Ktx, sxzm, out, NX, NY, NZ, band);
  return (int)cudaGetLastError();
}

// r == nullptr: out = A x (kernel #2); otherwise out = r - A x (kernel #3).
// With cy or cz (either may be null): kernel #9 in the same two forms.
int kron_t23_m_launch(const float* x, const float* mx2, const float* t1,
                      const float* Kty, const float* KtzT, const float* sx2d,
                      const float* sycol, const float* s23m, const float* myb,
                      const float* mzrow, const float* cy, const float* cz,
                      const float* r, float* out, int NX, int NY, int NZ,
                      int band, float sigma, void* stream) {
  if (band < 0 || band > kMaxBand) return (int)cudaErrorInvalidValue;
  const bool grid = cy != nullptr || cz != nullptr;
  auto kern = r == nullptr
      ? (grid ? kron_t23_m<false, true> : kron_t23_m<false, false>)
      : (grid ? kron_t23_m<true, true> : kron_t23_m<true, false>);
  kern<<<tile_grid(NZ, NY, NX), dim3(kTK, kTR), t23_smem(band),
         (cudaStream_t)stream>>>(x, mx2, t1, Kty, KtzT, sx2d, sycol, s23m,
                                 myb, mzrow, cy, cz, r, out, NX, NY, NZ, band,
                                 sigma);
  return (int)cudaGetLastError();
}

int kron_t1_launch(const float* x, const uint8_t* bc, const float* Ktx,
                   const float* sxz, float* out, int NX, int NY, int NZ,
                   int band, void* stream) {
  if (band < 0 || band > kMaxBand) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((kRows + 2 * band) * kTK + (2 * band + 1) * kRows);
  kron_t1<<<tile_grid(NZ, NX, NY), dim3(kTK, kTR), smem,
            (cudaStream_t)stream>>>(x, bc, Ktx, sxz, out, NX, NY, NZ, band);
  return (int)cudaGetLastError();
}

// r == nullptr: out = A v (kernel #5); otherwise out = r - A v (kernel #6).
// With cy or cz (either may be null): kernel #8 in the same two forms.
int kron_t23_launch(const float* v, const uint8_t* bc, const float* t1,
                    const float* Kty, const float* KtzT, const float* sx2d,
                    const float* sycol, const float* s23, const float* cy,
                    const float* cz, const float* r, float* out, int NX,
                    int NY, int NZ, int band, float sigma, void* stream) {
  if (band < 0 || band > kMaxBand) return (int)cudaErrorInvalidValue;
  const bool grid = cy != nullptr || cz != nullptr;
  auto kern = r == nullptr
      ? (grid ? kron_t23<kApply, true> : kron_t23<kApply, false>)
      : (grid ? kron_t23<kResidual, true> : kron_t23<kResidual, false>);
  kern<<<tile_grid(NZ, NY, NX), dim3(kTK, kTR), t23_smem(band),
         (cudaStream_t)stream>>>(v, bc, t1, Kty, KtzT, sx2d, sycol, s23, cy,
                                 cz, r, nullptr, nullptr, nullptr, 0, out,
                                 nullptr, nullptr, NX, NY, NZ, band, sigma);
  return (int)cudaGetLastError();
}

// Kernel #7: one Chebyshev-4 half-step (kstep = 0: init, v = x).
int kron_t23_cheb_launch(const float* v, const uint8_t* bc, const float* t1,
                         const float* Kty, const float* KtzT,
                         const float* sx2d, const float* sycol,
                         const float* s23, const float* x, const float* r,
                         const float* dinv, const float* lmax, int kstep,
                         float* xo, float* ro, float* zo, int NX, int NY,
                         int NZ, int band, float sigma, void* stream) {
  if (band < 0 || band > kMaxBand || kstep < 0)
    return (int)cudaErrorInvalidValue;
  kron_t23<kCheb, false><<<tile_grid(NZ, NY, NX), dim3(kTK, kTR),
                           t23_smem(band), (cudaStream_t)stream>>>(
      v, bc, t1, Kty, KtzT, sx2d, sycol, s23, nullptr, nullptr, r, x, dinv,
      lmax, kstep, ro, xo, zo, NX, NY, NZ, band, sigma);
  return (int)cudaGetLastError();
}

}  // extern "C"
