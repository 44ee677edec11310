// Hand-written Hopper (sm_90a) kernel for the whole-lattice Kronecker-sum
// apply.
//
// Replaces the Pallas kernel of pmg_dolfinx_tpu/ops/pallas_kron.py:
//   kron_fused_march<BAND> (and kron_fused_wide) <- _kernel
//                                                (PallasKronLaplacian)
// which computes, on the bc-zeroed xb = where(bc, 0, x),
//   y = (Kx ._x xb) * myz + (Ky ._y xb) * mxz + (Kz ._z xb) * mxy
// and returns where(bc, x, y); K the per-axis 1D stiffness (kappa folded
// in), myz = my (x) mz etc. the lumped-mass planes. The TPU kernel keeps the
// whole padded lattice in VMEM so that none of the three terms reaches
// device memory.
//
// What bounds it on this card. K is the assembled 1D GLL stiffness, banded
// with half-width P, so an output needs 3 (2P+1) FMAs (39 at p=6): the
// apply is bound by its bytes, x read, y written, the 1-byte marker and the
// three mass planes: ~18.6 MB at 127^3 (p=6, 2,048,383 dofs), 0.0056 ms at
// 3.35 TB/s; ~146 MB at 253^3, 0.0437 ms.
//
// Design: one march along x (kron_fused_march). A block of 8 warps owns a
// tile of 64 (z) x 8 (y) outputs, two neighbouring z a lane and a warp a
// row, and marches along x over a chunk of planes plus a BAND-plane halo
// at each end; the chunk is cut short until every SM has a block
// (ops/kron_fused.py:fused_plan, the rule of kron_t1_m's march).
//   - Each arriving plane's tile with a BAND-wide y/z halo is loaded once:
//     every thread fetches its share of the tile (x and the marker byte)
//     kAhead planes ahead into registers, zeroes the marked points as it
//     stores them into one of kAhead shared buffers, and one barrier a
//     plane publishes it. Rows of 127 or 253 floats are not 16-byte
//     aligned, so the global loads are 4-byte, whole tile rows per warp.
//   - y- and z-terms come from the arrived plane alone. A lane reads its
//     column pair's 2 BAND + 1 halo rows as float2 (two scalars for an odd
//     band) and its row's 2 BAND + 2 z neighbours as BAND + 1 float2, so
//     each shared-memory load feeds two outputs. Ky's band is warp-uniform
//     (float4 broadcasts), the lanes' Kz bands sit in shared memory as
//     float2 pairs. The sums wait BAND planes, until the x-term completes,
//     in a per-thread ring in shared memory.
//   - x-term: each lane keeps the last 2 BAND + 1 centre values of its two
//     outputs in registers; output plane i = (arrived plane) - BAND sums
//     Kx[i, i - BAND + d] over them, the chunk's band of Kx read as
//     float4 broadcasts.
//   - The plane loop is unrolled by 2 BAND + 2, a multiple of every ring's
//     length, so each ring slot is a compile-time register or address and
//     nothing is shifted from plane to plane.
//   - Epilogue: myz[j, k] is the same on every plane (a register); mxz[i,
//     k] and mxy[i, j] are staged for the chunk in shared memory. A marked
//     point's output is x itself: the thread writes it when the plane
//     arrives (its own x and marker are loaded beside the tile) and skips
//     it when the plane's y is written, BAND planes later.
// What holds it near a fifth of its bound (PERF.md): at 128 registers (the
// x rings, the prefetched tile, the windows) a block of 8 warps runs two
// to an SM, 16 warps, and each output still costs ~150 instructions (39
// FMAs, ~16 shared loads, the tile's loads, stores and indices, the
// barrier); the haloed tile is read ~3 times from L2.
// The band is a template parameter (kMaxBand and below); the launcher
// takes the widest band of the three matrices' nonzero ranges
// (ops/kron_fused.py:band_ranges), so any banded K computes the dense
// product. Above kMaxBand, kron_fused_wide is the runtime-width form: a
// thread per output summing each row's range from L1/L2 (the kernel this
// march replaced).
//
// Bits. Each line sum starts from 0 and adds its terms in fmaf, in
// ascending order; the march's band holds zero coefficients outside a
// row's nonzero range [lo, hi), and adding fmaf(0, v, s) to a sum that
// started from +0 leaves it unchanged, so the three sums are those of
// kron_fused_wide, which sums exactly [lo, hi). The epilogue is written as
// the contraction nvcc chose for s1 * myz + s2 * mxz + s3 * mxy in the
// kernel this march replaced, fmaf(s3, mxy, fmaf(s1, myz, s2 * mxz)), so
// both kernels give its bits (left to the compiler, the march's
// contraction differed). True f32 FMA throughout (precision="highest").
// There is no padding and no size limit: the JAX class's VMEM bound on
// the lattice (pallas_kron.py:17-19) has no counterpart here.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (cudaErrorInvalidValue for a plan the kernels
// do not take) so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>
#include <utility>

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 8;         // warps per march block, one tile row each
constexpr int kThreads = kLanes * kWarps;
constexpr int kTZ = 2 * kLanes;   // tile extent along z: two outputs a lane
constexpr int kMaxBand = 8;       // the largest templated band
constexpr int kMaxChunk = 64;     // planes a march block outputs
constexpr int kAhead = 2;         // planes a thread's tile loads run ahead
constexpr int kMinBlocks = 2;     // march blocks per SM: 128 registers
constexpr int kMaxSmem = 227 * 1024;

// A band row padded to whole float4s, so a warp reads it as broadcasts.
__host__ __device__ constexpr int band_pad(int band) {
  return (2 * band + 1 + 3) & ~3;
}

// The haloed tile of one plane, and a thread's share of it.
template <int BAND>
struct Tile {
  static constexpr int HY = kWarps + 2 * BAND;    // rows with the y halo
  static constexpr int HZ = kTZ + 2 * BAND;       // columns with the z halo
  static constexpr int N = HY * HZ;
  static constexpr int E = (N + kThreads - 1) / kThreads;
};

// Shared memory of a march block (floats): a tile buffer per plane in
// flight, the chunk's Kx band, the tile's Ky band, the chunk's mxz / mxy
// rows for the tile, each thread's ring of its y/z sums (BAND + 1 planes,
// a float2 of s2 and one of s3 a plane) and the lanes' Kz bands.
__host__ __device__ constexpr size_t march_smem(int band, int chunk) {
  return sizeof(float) *
         (kAhead * (size_t)(kWarps + 2 * band) * (kTZ + 2 * band) +
          (size_t)(chunk + kWarps) * band_pad(band) +
          (size_t)chunk * (kTZ + kWarps) + (size_t)(band + 1) * 4 * kThreads +
          (size_t)(2 * band + 1) * 2 * kLanes);
}

// The march: see the head of this file. The plane loop is unrolled by U =
// 2 BAND + 2, a multiple of the x ring's U slots, of the BAND + 1 slots of
// the y/z sums and of the kAhead prefetch slots and tile buffers, so every
// ring index is a compile-time constant and no value moves between
// registers from one plane to the next.
template <int BAND>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
kron_fused_march(const float* __restrict__ x,
                 const unsigned char* __restrict__ bc,
                 const float* __restrict__ Kx, const float* __restrict__ Ky,
                 const float* __restrict__ Kz, const float* __restrict__ myz,
                 const float* __restrict__ mxz, const float* __restrict__ mxy,
                 float* __restrict__ out, int NX, int NY, int NZ, int chunk) {
  using T = Tile<BAND>;
  constexpr int D = 2 * BAND + 1, DP = band_pad(BAND), E = T::E;
  constexpr int HZ = T::HZ, U = 2 * BAND + 2, Q = BAND + 1;
  static_assert(U % kAhead == 0, "the prefetch slots must divide U");
  extern __shared__ float4 smem4[];
  float* sT = reinterpret_cast<float*>(smem4);   // [kAhead][N] bc-zeroed
  float* sKx = sT + kAhead * T::N;               // [chunk][DP] Kx band
  float* sKy = sKx + chunk * DP;                 // [kWarps][DP] Ky band
  float* sMxz = sKy + kWarps * DP;               // [chunk][64] mxz
  float* sMxy = sMxz + chunk * kTZ;              // [chunk][kWarps] mxy
  float2* sS = reinterpret_cast<float2*>(sMxy + chunk * kWarps);
  // sS[(q * 2 + {0: s2, 1: s3}) * kThreads + tid]: the thread's two
  // outputs' sums of plane slot q.
  float2* sKz = sS + Q * 2 * kThreads;   // [D][32]: Kz[k + h, k + h - B + d]
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kLanes + lane;
  const int k0 = blockIdx.x * kTZ, j0 = blockIdx.y * kWarps;
  const int i0 = blockIdx.z * chunk, i1 = min(i0 + chunk, NX);
  const int k = k0 + 2 * lane, j = j0 + warp;   // outputs (j, k), (j, k + 1)
  const bool own[2] = {k < NZ && j < NY, k + 1 < NZ && j < NY};
  const int cen = own[0] ? j * NZ + k : 0;
  const int64_t plane = (int64_t)NY * NZ;

  // Stage the bands and the mass rows.
  for (int t = tid; t < chunk * DP; t += kThreads) {
    const int r = t / DP, d = t - r * DP, a = i0 + r, c = a - BAND + d;
    sKx[t] = d < D && a < NX && c >= 0 && c < NX ? Kx[(int64_t)a * NX + c]
                                                 : 0.f;
  }
  for (int t = tid; t < kWarps * DP; t += kThreads) {
    const int r = t / DP, d = t - r * DP, b = j0 + r, c = b - BAND + d;
    sKy[t] = d < D && b < NY && c >= 0 && c < NY ? Ky[(int64_t)b * NY + c]
                                                 : 0.f;
  }
  for (int t = tid; t < chunk * kTZ; t += kThreads) {
    const int i = i0 + t / kTZ, kk = k0 + t % kTZ;
    sMxz[t] = i < NX && kk < NZ ? mxz[(int64_t)i * NZ + kk] : 0.f;
  }
  for (int t = tid; t < chunk * kWarps; t += kThreads) {
    const int i = i0 + t / kWarps, jj = j0 + t % kWarps;
    sMxy[t] = i < NX && jj < NY ? mxy[(int64_t)i * NY + jj] : 0.f;
  }
  for (int t = tid; t < D * kLanes; t += kThreads) {
    const int d = t / kLanes, l = t % kLanes;
    float v[2];
    for (int h = 0; h < 2; ++h) {
      const int kh = k0 + 2 * l + h, c = kh - BAND + d;
      v[h] = kh < NZ && c >= 0 && c < NZ ? Kz[(int64_t)kh * NZ + c] : 0.f;
    }
    sKz[t] = make_float2(v[0], v[1]);
  }
  float myzk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) myzk[h] = own[h] ? myz[cen + h] : 0.f;
  // The thread's share of a tile: element e is tile point tid + e *
  // kThreads, at plane offset goff[e] when it lies in the lattice.
  int goff[E];
  unsigned inside = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int t = tid + e * kThreads;
    const int y = j0 - BAND + t / HZ, z = k0 - BAND + t % HZ;
    const bool in = t < T::N && y >= 0 && y < NY && z >= 0 && z < NZ;
    goff[e] = in ? y * NZ + z : 0;
    inside |= (in ? 1u : 0u) << e;
  }
  __syncthreads();

  // Plane a in prefetch slot s: the tile's x and marker bytes, and the
  // thread's own outputs' x and marker (zero / clear outside the lattice).
  float px[kAhead][E], cx[kAhead][2];
  unsigned pb[kAhead][E], cb[kAhead][2];
  auto fetch = [&](int s, int a) {
    const bool ain = a >= 0 && a < NX;
    const float* xa = x + (ain ? a * plane : 0);
    const unsigned char* ba = bc + (ain ? a * plane : 0);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool in = ain && ((inside >> e) & 1u);
      px[s][e] = in ? xa[goff[e]] : 0.f;
      pb[s][e] = in ? ba[goff[e]] : 0u;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      cx[s][h] = ain && own[h] ? xa[cen + h] : 0.f;
      cb[s][h] = ain && own[h] ? ba[cen + h] : 0u;
    }
  };

  const int an0 = i0 - BAND, an1 = i1 + BAND;   // planes the march visits
#pragma unroll
  for (int s = 0; s < kAhead; ++s) fetch(s, an0 + s);
  float xr[2][U];      // xr[h][(a - an0) % U]: the centre xb of plane a
  unsigned mark = 0u;  // bits 2b, 2b + 1: the markers of plane an - b
#pragma unroll
  for (int u = 0; u < U; ++u) xr[0][u] = xr[1][u] = 0.f;
  for (int ab = an0; ab < an1; ab += U) {
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const int an = ab + s;
      if (an >= an1) break;
      const int slot = s % kAhead;
      float* buf = sT + slot * T::N;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int t = tid + e * kThreads;
        if (t < T::N) buf[t] = pb[slot][e] != 0u ? 0.f : px[slot][e];
      }
      const float ox[2] = {cx[slot][0], cx[slot][1]};
      const bool marked[2] = {cb[slot][0] != 0u, cb[slot][1] != 0u};
      fetch(slot, an + kAhead);
      __syncthreads();
      // Plane an: its y- and z-sums when it is one of the chunk's outputs
      // (block-uniform), and every plane's centre values for the x ring.
      // The thread's column pair starts at tile column 2 lane + BAND.
      const float* col = buf + warp * HZ + 2 * lane + BAND;   // (j - BAND)
      float c2[2];
      if (an >= i0 && an < i1) {
        float s2[2] = {0.f, 0.f}, s3[2] = {0.f, 0.f};
        const float4* ky4 = reinterpret_cast<const float4*>(sKy + warp * DP);
#pragma unroll
        for (int qd = 0; qd < DP / 4; ++qd) {
          const float4 c = ky4[qd];
          const float cs[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = 4 * qd + e;
            if (d < D) {
              float v0, v1;
              if constexpr (BAND % 2 == 0) {
                const float2 v =
                    *reinterpret_cast<const float2*>(col + d * HZ);
                v0 = v.x;
                v1 = v.y;
              } else {
                v0 = col[d * HZ];
                v1 = col[d * HZ + 1];
              }
              s2[0] = fmaf(cs[e], v0, s2[0]);
              s2[1] = fmaf(cs[e], v1, s2[1]);
              if (d == BAND) {
                c2[0] = v0;
                c2[1] = v1;
              }
            }
          }
        }
        // The row's window, tile columns 2 lane .. 2 lane + 2 BAND + 1.
        const float2* row =
            reinterpret_cast<const float2*>(buf + (warp + BAND) * HZ) + lane;
        float w[2 * BAND + 2];
#pragma unroll
        for (int m = 0; m <= BAND; ++m) {
          const float2 v = row[m];
          w[2 * m] = v.x;
          w[2 * m + 1] = v.y;
        }
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float2 kz = sKz[d * kLanes + lane];
          s3[0] = fmaf(kz.x, w[d], s3[0]);
          s3[1] = fmaf(kz.y, w[d + 1], s3[1]);
        }
        sS[(s % Q * 2) * kThreads + tid] = make_float2(s2[0], s2[1]);
        sS[(s % Q * 2 + 1) * kThreads + tid] = make_float2(s3[0], s3[1]);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (marked[h] && own[h]) out[an * plane + cen + h] = ox[h];
      } else {
        c2[0] = col[BAND * HZ];
        c2[1] = col[BAND * HZ + 1];
      }
      xr[0][s] = c2[0];
      xr[1][s] = c2[1];
      mark = (mark << 2) | (marked[0] ? 1u : 0u) | (marked[1] ? 2u : 0u);
      // Output plane i = an - BAND has all of its x-terms now: planes i -
      // BAND + d sit in xr[.][(s + 2 + d) % U] (-2 BAND = 2 mod U), its
      // sums in slot (s + 1) % Q (-BAND = 1 mod Q).
      const int i = an - BAND;
      if (i >= i0) {
        const float4* k4 =
            reinterpret_cast<const float4*>(sKx + (i - i0) * DP);
        float s1[2] = {0.f, 0.f};
#pragma unroll
        for (int qd = 0; qd < DP / 4; ++qd) {
          const float4 c = k4[qd];
          const float cs[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = 4 * qd + e;
            if (d < D) {
              s1[0] = fmaf(cs[e], xr[0][(s + 2 + d) % U], s1[0]);
              s1[1] = fmaf(cs[e], xr[1][(s + 2 + d) % U], s1[1]);
            }
          }
        }
        const float2 s2 = sS[((s + 1) % Q * 2) * kThreads + tid];
        const float2 s3 = sS[((s + 1) % Q * 2 + 1) * kThreads + tid];
        const float2 mz = *reinterpret_cast<const float2*>(
            sMxz + (i - i0) * kTZ + 2 * lane);
        const float my = sMxy[(i - i0) * kWarps + warp];
        const unsigned m = mark >> (2 * BAND);
        float* o = out + i * plane + cen;
        // s1 * myz + s2 * mxz + s3 * mxy, contracted as nvcc contracts it in
        // kron_fused_wide (the parent's bits).
        if (own[0] && !(m & 1u))
          o[0] = fmaf(s3.x, my, fmaf(s1[0], myzk[0], s2.x * mz.x));
        if (own[1] && !(m & 2u))
          o[1] = fmaf(s3.y, my, fmaf(s1[1], myzk[1], s2.y * mz.y));
      }
    }
  }
}

__device__ __forceinline__ float masked(const float* __restrict__ x,
                                        const unsigned char* __restrict__ bc,
                                        int64_t p) {
  return bc[p] ? 0.f : x[p];
}

// The runtime-width form: one thread per output, 32 x 8 blocks, each line
// sum over its row's range [lo, hi) read straight from L1/L2.
__global__ void __launch_bounds__(kThreads)
kron_fused_wide(const float* __restrict__ x,
                const unsigned char* __restrict__ bc,
                const float* __restrict__ Kx, const float* __restrict__ Ky,
                const float* __restrict__ Kz, const int* __restrict__ rng,
                const float* __restrict__ myz, const float* __restrict__ mxz,
                const float* __restrict__ mxy, float* __restrict__ out,
                int NX, int NY, int NZ) {
  const int k = blockIdx.x * kLanes + threadIdx.x;
  const int j = blockIdx.y * kWarps + threadIdx.y;
  const int i = blockIdx.z;
  if (j >= NY || k >= NZ) return;
  const int64_t plane = (int64_t)NY * NZ;
  const int64_t g = i * plane + (int64_t)j * NZ + k;
  // rng: [lo_x | hi_x | lo_y | hi_y | lo_z | hi_z], NX, NX, NY, NY, NZ, NZ.
  const int* ry = rng + 2 * NX;
  const int* rz = ry + 2 * NY;
  float s1 = 0.f, s2 = 0.f, s3 = 0.f;
  const float* kx = Kx + (int64_t)i * NX;
  for (int a = rng[i]; a < rng[NX + i]; ++a)
    s1 = fmaf(kx[a], masked(x, bc, a * plane + (int64_t)j * NZ + k), s1);
  const float* ky = Ky + (int64_t)j * NY;
  for (int b = ry[j]; b < ry[NY + j]; ++b)
    s2 = fmaf(ky[b], masked(x, bc, i * plane + (int64_t)b * NZ + k), s2);
  const float* kz = Kz + (int64_t)k * NZ;
  const int64_t line = i * plane + (int64_t)j * NZ;
  for (int c = rz[k]; c < rz[NZ + k]; ++c)
    s3 = fmaf(kz[c], masked(x, bc, line + c), s3);
  // s1 * myz + s2 * mxz + s3 * mxy as nvcc contracts it (written out, so
  // that both kernels round alike).
  const float y = fmaf(s3, mxy[(int64_t)i * NY + j],
                       fmaf(s1, myz[(int64_t)j * NZ + k],
                            s2 * mxz[(int64_t)i * NZ + k]));
  out[g] = bc[g] ? x[g] : y;
}

template <int BAND>
int launch_march(const float* x, const unsigned char* bc, const float* Kx,
                 const float* Ky, const float* Kz, const float* myz,
                 const float* mxz, const float* mxy, float* out, int NX,
                 int NY, int NZ, int chunk, cudaStream_t stream) {
  // One opt-in per band and device for the longest chunk's shared memory.
  static std::atomic<uint64_t> granted{0};
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = dev >= 0 && dev < 64 ? uint64_t{1} << dev : 0;
  if (bit == 0 || (granted.load() & bit) == 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kron_fused_march<BAND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)march_smem(BAND, kMaxChunk));
    if (err != cudaSuccess) return (int)err;
    granted.fetch_or(bit);
  }
  const dim3 grid((unsigned)((NZ + kTZ - 1) / kTZ),
                  (unsigned)((NY + kWarps - 1) / kWarps),
                  (unsigned)((NX + chunk - 1) / chunk));
  kron_fused_march<BAND><<<grid, dim3(kLanes, kWarps),
                           march_smem(BAND, chunk), stream>>>(
      x, bc, Kx, Ky, Kz, myz, mxz, mxy, out, NX, NY, NZ, chunk);
  return (int)cudaGetLastError();
}

template <int... Bs>
int dispatch_band(int band, std::integer_sequence<int, Bs...>,
                  const float* x, const unsigned char* bc, const float* Kx,
                  const float* Ky, const float* Kz, const float* myz,
                  const float* mxz, const float* mxy, float* out, int NX,
                  int NY, int NZ, int chunk, cudaStream_t stream) {
  int rc = (int)cudaErrorInvalidValue;
  ((band == Bs ? (rc = launch_march<Bs>(x, bc, Kx, Ky, Kz, myz, mxz, mxy,
                                         out, NX, NY, NZ, chunk, stream),
                  0)
               : 0),
   ...);
  return rc;
}

}  // namespace

extern "C" {

// out = where(bc, x, y) on an (NX, NY, NZ) lattice; Kx (NX, NX), Ky (NY,
// NY), Kz (NZ, NZ) row-major; rng the int32 nonzero row ranges as above;
// myz (NY, NZ), mxz (NX, NZ), mxy (NX, NY). The plan (ops/kron_fused.py:
// fused_plan): band in 0..kMaxBand, the widest distance of a nonzero from
// the diagonal over the three matrices, with chunk (1..kMaxChunk) planes
// a block, launches kron_fused_march; band -1 launches kron_fused_wide
// (chunk unused).
int kron_fused_launch(const float* x, const unsigned char* bc,
                      const float* Kx, const float* Ky, const float* Kz,
                      const int* rng, const float* myz, const float* mxz,
                      const float* mxy, float* out, int NX, int NY, int NZ,
                      int band, int chunk, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if ((int64_t)NX * NY * NZ >= (int64_t{1} << 31))
    return (int)cudaErrorInvalidValue;
  if (band == -1) {
    if (NX > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((NZ + kLanes - 1) / kLanes),
                    (unsigned)((NY + kWarps - 1) / kWarps), (unsigned)NX);
    kron_fused_wide<<<grid, dim3(kLanes, kWarps), 0, st>>>(
        x, bc, Kx, Ky, Kz, rng, myz, mxz, mxy, out, NX, NY, NZ);
    return (int)cudaGetLastError();
  }
  if (band < 0 || band > kMaxBand || chunk < 1 || chunk > kMaxChunk ||
      (NY + kWarps - 1) / kWarps > 65535 ||
      (NX + chunk - 1) / chunk > 65535 ||
      march_smem(band, chunk) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  return dispatch_band(band, std::make_integer_sequence<int, kMaxBand + 1>{},
                       x, bc, Kx, Ky, Kz, myz, mxz, mxy, out, NX, NY, NZ,
                       chunk, st);
}

}  // extern "C"
