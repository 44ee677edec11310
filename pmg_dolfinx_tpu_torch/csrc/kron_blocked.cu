// Hand-written Hopper (sm_90a) kernels for the blocked Kronecker-sum apply.
//
// Replaces the Pallas kernels of pmg_dolfinx_tpu/ops/pallas_kron_blocked.py
// (kron_t23_m<BAND, RESIDUAL, GRID, FULL>):
//   kron_t1_m<B, false>          <- _kernel_t1_m       (x-contraction, separable bc mask)
//   kron_t23_m<B, 0, 0, false>   <- _kernel_t23_m      (y/z-contractions + bc epilogue)
//   kron_t23_m<B, 1, 0, false>   <- _kernel_t23_res_m  (the same, fused  r - A v)
//   kron_t1_m<B, true>           <- _kernel_t1         (x-contraction, full bc array)
//   kron_t23_m<B, 0, 0, true>    <- _kernel_t23        (y/z-contractions, full bc array)
//   kron_t23_m<B, 1, 0, true>    <- _kernel_t23_res    (the same, fused  r - A v)
//   kron_t23<kCheb>              <- _kernel_t23_cheb   (the same, fused Chebyshev-4 step)
//   kron_t23_m<B, R, 1, false>   <- _kernel_t23_grid_m (kernel 2 on a device-grid shard)
//   kron_t23_m<B, R, 1, true>    <- _kernel_t23_grid   (the same, full bc array)
// Above band kT23MarchMaxBand the full-bc #5, #6 and #8 run as the staged
// tile kron_t23<kApply|kResidual, GRID> instead (see below).
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
//   t1'      = Ktx-contraction of (where(bc, 0, x) * sxz)     [kernel #4]
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
// Design of kron_t1_m and kron_t23_m (kernels #1-#6, #8, #9): streaming
// marches. A tile staged in shared memory (kron_t23 below) costs two
// shared-memory loads per FMA and rereads its halo; these two walk the
// lattice once instead, with the band's window in registers:
//   kron_t1_m: a thread owns one (j, k) lane and marches along x over a
//     chunk of planes, keeping the last 2P+1 scaled inputs w in a
//     register ring; out[a] sums Ktx[a, a-P+d] w[a-P+d]. The chunk's band
//     of Ktx is staged once in shared memory and read as warp-uniform
//     float4 broadcasts. x is read once per chunk plus a 2P-plane halo;
//     there is no barrier inside the march. The mask is a template flag:
//     kernel #1 scales by my_j sxzm, kernel #4 reads the bc byte of each
//     entry beside x and zeroes a marked one (FULL), as the tiles did.
//   kron_t23_m: a thread owns one (i, k) lane and marches along y inside
//     x-plane i. The 2P+1 rows of w^ sit in a register ring for the
//     y-contraction (Kty rows as uniform broadcasts, as above). Each warp
//     writes every arriving row of w^ (with its z halo), raw x and s23m
//     into rings of 2P+1 rows in its own shared memory, so the
//     z-contraction of row j (its 2P+1 KtzT coefficients stay in
//     registers) and the Dirichlet epilogue read row j from there when
//     row j+P arrives: x is read from HBM once, and the only barrier is a
//     __syncwarp per row. FULL (kernels #5, #6, #8) reads the bc byte of
//     each row beside x, kept raw until the row arrives; w^ = where(bc,
//     0, x) * s23, and the row's marker rides to the epilogue in the sign
//     bit of its s23 ring entry (s23 >= 0), which takes where(bc, x, y).
//     Its residual and shard forms hold more operands, so they fetch the
//     byte only kNear rows ahead to fit 128 registers.
// What bounds them is the load stream: a march issues one row of each
// lattice per step, so each thread fetches its HBM operands kAhead rows
// ahead into registers (the loop unrolled by kAhead keeps every slot a
// compile-time register). The warps of a block lie along z, so a block
// reads whole contiguous rows. The ring indices must be compile-time too
// (a register array with a runtime index spills), so both kernels are
// templated on the band and the launchers dispatch bands 0..kMaxBand. The
// sums keep the order of the tiled kernels (fmaf over d ascending from 0,
// zero terms outside the lattice), so the results are the same bits.
//
// Design of kron_t23, the tile: kernel #7 (the fused Chebyshev step) at
// every band, and #5, #6, #8 above band kT23MarchMaxBand, where the
// march's residual form spills and ran slower. A block owns a 32 (z) x 32
// (y) tile of outputs, 256 threads of 32 x 8, each thread 4 outputs along
// y; z is fastest across a warp, so every global access coalesces. The
// block stages its masked, scaled input tile WITH a halo of `band` planes
// in shared memory, and the band of each 1D matrix its rows need, so the
// 2P+1 neighbour reads per axis come from shared memory instead of 26
// L1/L2 loads per output: global traffic per output drops to about
// (32+2P)/32 input reads plus the output. Terms outside the lattice are
// staged as zeros, so every thread runs the same 2P+1-term loops. Sums run
// in true f32 FMA on the CUDA cores (the JAX package's precision="highest"
// contract), in ascending neighbour order, the order the marches keep;
// only the order of addition differs from a dense product.
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
// precision="high" (bf16x3, the `if high:` branches of the TPU kernels).
// The same source built with -DPMG_HIGH=1 is a second library whose entry
// points launch the HIGH = true instantiations (ops/kron_blocked.py builds
// it the first time 'high' is asked for). Each operand of a contraction
// that the TPU kernel splits -- Ktx and the masked, scaled w of kernels
// #1/#4; Kty, KtzT and w^ of kron_t23_m and kron_t23 -- becomes (hi, lo) =
// (bf16_rn(a), bf16_rn(a - hi)) (split_pack); the products hi*hi, hi*lo
// and lo*hi are exact in f32, each is summed over the band in its own f32
// accumulator (Acc3), the lo*lo product is dropped, and the three sums are
// added as hh + (hl + lh): pallas_util.split_bf16 and _dot3. A split value
// is held packed in one 32-bit word (hi in the high half, lo in the low
// half), so the rings, the staged bands and the tiles keep their sizes;
// the sigma term reads w^ in f32, recomputed from x and the scale as it
// arrived. t1', the s3 scale, sigma and the epilogues stay f32.
//
// Every C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (or cudaErrorInvalidValue for a band the
// tiles cannot hold) so the Python wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "bf16x3.cuh"  // split_pack, hi_part, lo_part, Acc3

#ifndef PMG_HIGH
#define PMG_HIGH 0
#endif

namespace {

// The instantiations this library's entry points launch (see the head).
constexpr bool kHigh = PMG_HIGH != 0;

// A value as the HIGH kernels keep it: split and packed, else as is.
template <bool HIGH>
__device__ __forceinline__ float keep(float a) {
  return HIGH ? split_pack(a) : a;
}

constexpr int kTK = 32;           // tile extent along z (one warp)
constexpr int kTR = 8;            // thread rows per block
constexpr int kRPT = 4;           // outputs per thread along the tile rows
constexpr int kRows = kTR * kRPT; // tile extent along y
constexpr int kMaxBand = 16;          // keeps kernel 2's tiles under 48 KB
// Kernels #5, #6 and #8 run the y-march (kron_t23_m with FULL) up to this
// band; above it the march's residual form measured slower than the tile
// on the H100, and the tile kron_t23<kApply|kResidual, GRID> serves them.
// The wrapper's plan (ops/kron_blocked.py:t23_plan, the same band) picks
// the form; the launcher refuses the march above this band.
constexpr int kT23MarchMaxBand = 12;

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

// The marching kernels' blocks: 32 lanes along z by kWarps warps, one
// output lane per thread, each warp on its own j (kron_t1_m) or i
// (kron_t23_m) and the block marching one chunk of the third axis.
constexpr int kWarps = 8;
constexpr int kLanes = 32;
// March chunks: kLongChunk planes (a 2P-plane halo over more outputs)
// when that still gives every SM 4 blocks, else the longest of
// kShortChunk, kShortChunk / 2, ..., kMinChunk that gives every SM a
// block (see march_chunk).
constexpr int kLongChunk = 64;
constexpr int kShortChunk = 32;
constexpr int kMinChunk = 2;

// A band row padded to whole float4s, so a warp reads it as broadcasts.
__host__ __device__ constexpr int band_pad(int band) {
  return (2 * band + 1 + 3) & ~3;
}

// Stage rows [r0, r0 + rows) of the band of the square n x n matrix K in
// shared memory: sK[r][d] = K[r0 + r, r0 + r - BAND + d] (HIGH: split and
// packed), zero outside the matrix and in the padding.
template <int BAND, bool HIGH>
__device__ __forceinline__ void stage_band(float* sK,
                                           const float* __restrict__ K,
                                           int r0, int rows, int n) {
  constexpr int D = 2 * BAND + 1, DP = band_pad(BAND);
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  for (int t = tid; t < rows * DP; t += kLanes * kWarps) {
    const int r = t / DP, d = t - r * DP;
    const int a = r0 + r, c = a - BAND + d;
    sK[t] = (d < D && a < n && c >= 0 && c < n)
                ? keep<HIGH>(K[(int64_t)a * n + c])
                : 0.f;
  }
}

// sum_d band[d] * v[d] as fmaf over d ascending from 0 (HIGH: Acc3 over
// the packed splits, band first as in _dot3(K, w)), the band row read
// from shared memory as float4 broadcasts.
template <int BAND, bool HIGH>
__device__ __forceinline__ float band_dot(const float* sKrow, const float* v) {
  constexpr int D = 2 * BAND + 1, DP = band_pad(BAND);
  const float4* k4 = reinterpret_cast<const float4*>(sKrow);
  float acc = 0.f;
  Acc3 acc3;
#pragma unroll
  for (int q = 0; q < DP / 4; ++q) {
    const float4 c = k4[q];
    const float cs[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (4 * q + e >= D) continue;
      if (HIGH)
        acc3.add(cs[e], v[4 * q + e]);
      else
        acc = fmaf(cs[e], v[4 * q + e], acc);
    }
  }
  return HIGH ? acc3.sum() : acc;
}

// Rows a thread's loads run ahead of its march: a slot's loads are
// issued kAhead rows before their use, so a warp keeps that many rows of
// its HBM streams in flight instead of waiting on every row's latency.
// The march loop is unrolled by kAhead, so every slot index is a
// compile-time register. kron_t23_m fetches its L2-resident operands
// (the s23m plane, the z halo) only kNear rows ahead, to save registers.
constexpr int kAheadT1 = 12;
constexpr int kAheadT23 = 8;
constexpr int kNear = 2;
// FULL kron_t23_m, which also streams the marker bytes, fetches its rows
// kAheadT23Full ahead, and its residual and shard forms fetch the bytes
// only kNear rows ahead: so every form fits 128 registers (8 rows ahead,
// the residual and shard forms spilled and ran slower).
constexpr int kAheadT23Full = 6;
// Shared memory of kron_t23_m: the chunk's Kty band, sycol and myb, and
// each warp's rings of w^ (with its z halo), raw x and s23m.
__host__ __device__ constexpr size_t t23_m_smem(int band, int chunk) {
  return sizeof(float) *
         (chunk * (band_pad(band) + 2) +
          kWarps * (2 * band + 1) * (3 * kLanes + 2 * band));
}
// kron_t23_m asks for two blocks per SM (at most 128 registers a thread)
// where two blocks' shared memory fits in an SM (228 KB on sm_90, 1 KB
// reserved per block): at one block, the residual form's extra stream (r)
// left the card half idle; at three, the main path's bands spill. Above
// that band (14-16) one block fits, and a register cap would only spill.
constexpr size_t kSmemPerSM = 228 * 1024;
__host__ __device__ constexpr int t23_m_min_blocks(int band) {
  return 2 * (t23_m_smem(band, kLongChunk) + 1024) <= kSmemPerSM ? 2 : 1;
}

// FULL = false: kernel #1, w = x * (my_j * sxzm) with the separable mask;
// FULL = true: kernel #4, w = where(bc, 0, x) * sxz with the bc lattice.
// HIGH: the ring and the Ktx band hold split_pack'ed values.
template <int BAND, bool FULL, bool HIGH>
__global__ void __launch_bounds__(kLanes * kWarps)
kron_t1_m(const float* __restrict__ x, const float* __restrict__ myb,
          const uint8_t* __restrict__ bc, const float* __restrict__ Ktx,
          const float* __restrict__ sxz, float* __restrict__ out, int NX,
          int NY, int NZ, int chunk, int kw) {
  constexpr int D = 2 * BAND + 1, DP = band_pad(BAND), U = kAheadT1;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);   // [chunk][DP] Ktx band
  const int k = (blockIdx.x * kw + threadIdx.y % kw) * kLanes + threadIdx.x;
  const int j = blockIdx.y * (kWarps / kw) + threadIdx.y / kw;
  const int a0 = blockIdx.z * chunk;
  const int a1 = min(a0 + chunk, NX);
  stage_band<BAND, HIGH>(sK, Ktx, a0, chunk, NX);
  __syncthreads();
  if (j >= NY || k >= NZ) return;
  const int64_t plane = (int64_t)NY * NZ;
  const float* xl = x + (int64_t)j * NZ + k;
  const uint8_t* bl = FULL ? bc + (int64_t)j * NZ + k : nullptr;
  const float* sl = sxz + k;
  float* ol = out + (int64_t)j * NZ + k;
  const float myj = FULL ? 0.f : myb[j];
  // Plane a arrives as x[a, j, k], sxz(m)[a, k] and (FULL) bc[a, j, k]
  // (zero, resp. set, outside the lattice and past the march); w[a] is
  // the tiled kernels' staged value: x * (my_j * sxzm), or where(bc, 0,
  // x * sxz). out[a - BAND] is summed then.
  const int an0 = a0 - BAND, an1 = a1 + BAND, aend = min(an1, NX);
  // The marker byte stays as loaded until its plane arrives: testing it
  // here would wait on the load at every fetch.
  float px[U], ps[U];
  unsigned pb[U];
  auto fetch = [&](int s, int a) {
    const bool in = a >= 0 && a < aend;
    px[s] = in ? xl[a * plane] : 0.f;
    ps[s] = in ? sl[(int64_t)a * NZ] : 0.f;
    if (FULL) pb[s] = in ? bl[a * plane] : 1u;
  };
#pragma unroll
  for (int s = 0; s < U; ++s) fetch(s, an0 + s);
  float ring[D];   // ring[d] = w[a - BAND + d] when out[a] is summed
#pragma unroll
  for (int d = 0; d < D; ++d) ring[d] = 0.f;
  for (int ab = an0; ab < an1; ab += U) {
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const int an = ab + s;
      if (an >= an1) break;
      const float w = FULL ? (pb[s] != 0 ? 0.f : px[s] * ps[s])
                           : px[s] * (myj * ps[s]);
      fetch(s, an + U);
#pragma unroll
      for (int d = 0; d + 1 < D; ++d) ring[d] = ring[d + 1];
      ring[D - 1] = keep<HIGH>(w);
      const int a = an - BAND;
      if (a >= a0)
        ol[a * plane] = band_dot<BAND, HIGH>(sK + (a - a0) * DP, ring);
    }
  }
}

// FULL = false: kernels #2, #3 and #9 with the separable masks, w^ = x *
// (mx_i * s23m) and the epilogue x (1 - mx_i my_j mz_k) + y mx_i; FULL =
// true: kernels #5, #6 and #8 with the bc lattice, w^ = where(bc, 0, x) *
// s23 and the epilogue where(bc, x, y) (mx2, myb and mzrow are null, and
// s23m is the unmasked s23). HIGH: the ring, the z ring rows of w^, kz
// and the Kty band hold split_pack'ed values, and the sigma term
// recomputes w^ from the raw x and s23m rows.
template <int BAND, bool RESIDUAL, bool GRID, bool FULL, bool HIGH>
__global__ void __launch_bounds__(kLanes * kWarps, t23_m_min_blocks(BAND))
kron_t23_m(const float* __restrict__ x, const float* __restrict__ mx2,
           const uint8_t* __restrict__ bc, const float* __restrict__ t1,
           const float* __restrict__ Kty, const float* __restrict__ KtzT,
           const float* __restrict__ sx2d, const float* __restrict__ sycol,
           const float* __restrict__ s23m, const float* __restrict__ myb,
           const float* __restrict__ mzrow, const float* __restrict__ cy,
           const float* __restrict__ cz, const float* __restrict__ r,
           float* __restrict__ out, int NX, int NY, int NZ, int chunk, int kw,
           float sigma) {
  constexpr int D = 2 * BAND + 1, DP = band_pad(BAND);
  constexpr int U = FULL ? kAheadT23Full : kAheadT23;
  constexpr int W = kLanes + 2 * BAND;   // a ring row: the warp's z + halo
  extern __shared__ float4 smem4[];
  float* sKy = reinterpret_cast<float*>(smem4);   // [chunk][DP] Kty band
  float* sSy = sKy + chunk * DP;                  // [chunk] sycol
  float* sMy = sSy + chunk;                       // [chunk] myb
  // This warp's rings of the last D rows: w^ [D][W], raw x and s23m
  // [D][32] (FULL: s23 with the row's marker in its sign bit).
  float* sW = sMy + chunk + threadIdx.y * D * (W + 2 * kLanes);
  float* sX = sW + D * W;
  float* sS = sX + D * kLanes;
  const int lane = threadIdx.x;
  const int k0 = (blockIdx.x * kw + threadIdx.y % kw) * kLanes, k = k0 + lane;
  const int i = blockIdx.y * (kWarps / kw) + threadIdx.y / kw;
  const int j0 = blockIdx.z * chunk;
  const int j1 = min(j0 + chunk, NY);
  stage_band<BAND, HIGH>(sKy, Kty, j0, chunk, NY);
  for (int t = threadIdx.y * kLanes + lane; t < chunk; t += kLanes * kWarps) {
    sSy[t] = j0 + t < NY ? sycol[j0 + t] : 0.f;
    if (!FULL) sMy[t] = j0 + t < NY ? myb[j0 + t] : 0.f;
  }
  __syncthreads();
  if (i >= NX || k0 >= NZ) return;  // the whole warp: both warp-uniform
  const bool kin = k < NZ;
  const int64_t plane = (int64_t)NY * NZ;
  const float* xi_pl = x + (int64_t)i * plane;
  const float mxi = FULL ? 0.f : mx2[i], sxi = sx2d[i];
  float kz[D];                       // KtzT[k - BAND + d, k]
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int kk = k - BAND + d;
    kz[d] = (kin && kk >= 0 && kk < NZ) ? keep<HIGH>(KtzT[(int64_t)kk * NZ + k])
                                        : 0.f;
  }
  // The z halo: lanes < BAND also load column k0 - BAND + lane, lanes >=
  // 32 - BAND column k0 + BAND + lane (2 BAND <= 32: one extra each).
  int hk = -1, hpos = -1;
  if (lane < BAND) {
    hk = k0 - BAND + lane;
    hpos = lane;
  } else if (lane >= kLanes - BAND) {
    hk = k0 + BAND + lane;
    hpos = 2 * BAND + lane;
  }
  const bool hin = hk >= 0 && hk < NZ;
  const float mzk = !FULL && kin ? mzrow[k] : 0.f;
  // Each lane's columns; a row adds a 32-bit in-plane offset (NY NZ < 2^31).
  const float* xk = xi_pl + k;
  const float* sk = s23m + k;
  const float* xh = xi_pl + (hin ? hk : 0);
  const float* sh = s23m + (hin ? hk : 0);
  const uint8_t* bi_pl = FULL ? bc + (int64_t)i * plane : nullptr;
  const float* tk = t1 + (int64_t)i * plane + k;
  const float* rk = RESIDUAL ? r + (int64_t)i * plane + k : nullptr;
  float* ok = out + (int64_t)i * plane + k;
  // Far slot s holds the HBM operands: x of row jn for its arrival, t1'
  // and r of row jn - BAND for its epilogue; near slot s % kNear the s23m
  // of row jn and the halo column's x, s23m (and marker byte); marker
  // slot s % KB the marker byte of row jn. Zero (resp. marked)
  // outside the lattice, the chunk and the march. A marker byte stays as
  // loaded until its row arrives: testing it at the fetch would wait on
  // the load.
  constexpr int KB = RESIDUAL || GRID ? kNear : U;
  static_assert(U % kNear == 0 && U % KB == 0,
                "near and marker slots rotate within the unroll");
  const int jn0 = j0 - BAND, jn1 = j1 + BAND, jend = min(jn1, NY);
  float px[U], pt[U], pr[U], ps[kNear], phx[kNear], phs[kNear];
  unsigned pb[KB], phb[kNear];
  auto fetch_bc = [&](int q, int jn) {
    pb[q] = jn >= 0 && jn < jend && kin ? bi_pl[jn * NZ + k] : 1u;
  };
  auto fetch_far = [&](int s, int jn) {
    const int o = jn * NZ;
    const bool row = jn >= 0 && jn < jend && kin;
    px[s] = row ? xk[o] : 0.f;
    const int je = jn - BAND;
    const bool epi = kin && je >= j0 && je < j1;
    pt[s] = epi ? tk[o - BAND * NZ] : 0.f;
    pr[s] = RESIDUAL && epi ? rk[o - BAND * NZ] : 0.f;
  };
  auto fetch_near = [&](int q, int jn) {
    const bool row = jn >= 0 && jn < jend;
    const int o = jn * NZ;
    ps[q] = row && kin ? sk[o] : 0.f;
    phx[q] = row && hin ? xh[o] : 0.f;
    phs[q] = row && hin ? sh[o] : 0.f;
    if (FULL) phb[q] = row && hin ? bi_pl[o + hk] : 1u;
  };
#pragma unroll
  for (int s = 0; s < U; ++s) fetch_far(s, jn0 + s);
#pragma unroll
  for (int q = 0; q < kNear; ++q) fetch_near(q, jn0 + q);
  if (FULL) {
#pragma unroll
    for (int q = 0; q < KB; ++q) fetch_bc(q, jn0 + q);
  }
  float ring[D];   // ring[d] = w^[j - BAND + d, k] when row j is summed
#pragma unroll
  for (int d = 0; d < D; ++d) ring[d] = 0.f;
  int slot = 0;    // the ring row of the arriving row jn
  for (int jb = jn0; jb < jn1; jb += U) {
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const int jn = jb + s;
      if (jn >= jn1) break;
      // Row jn arrives: w^ = x * (mx_i * s23m), or where(bc, 0, x * s23).
      // FULL keeps the row's marker in the sign bit of its s23 ring entry
      // (s23 >= 0), for the epilogue.
      const int q = s % kNear;
      const float xv = px[s], sv = ps[q];
      float wv, hw, sring = sv;
      if (FULL) {
        const bool bn = pb[s % KB] != 0;
        wv = bn ? 0.f : xv * sv;
        hw = phb[q] != 0 ? 0.f : phx[q] * phs[q];
        sring = __int_as_float(__float_as_int(sv) | (bn ? INT32_MIN : 0));
        fetch_bc(s % KB, jn + KB);
      } else {
        wv = xv * (mxi * sv);
        hw = phx[q] * (mxi * phs[q]);
      }
      const float tv = pt[s], rv = pr[s];
      fetch_far(s, jn + U);
      fetch_near(q, jn + kNear);
      const float wk = keep<HIGH>(wv);
      sW[slot * W + BAND + lane] = wk;
      if (hpos >= 0) sW[slot * W + hpos] = keep<HIGH>(hw);
      sX[slot * kLanes + lane] = xv;
      sS[slot * kLanes + lane] = sring;
#pragma unroll
      for (int d = 0; d + 1 < D; ++d) ring[d] = ring[d + 1];
      ring[D - 1] = wk;
      __syncwarp();
      const int j = jn - BAND;       // the row whose window is complete
      const int sj = slot >= BAND ? slot - BAND : slot + BAND + 1;
      if (++slot == D) slot = 0;
      if (j < j0) continue;
      const float t2 = band_dot<BAND, HIGH>(sKy + (j - j0) * DP, ring);
      const float* srow = sW + sj * W + lane;
      float t3 = 0.f;
      Acc3 t33;   // HIGH: _dot3(w^, KtzT), w^ first
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (HIGH)
          t33.add(srow[d], kz[d]);
        else
          t3 = fmaf(srow[d], kz[d], t3);
      }
      if (HIGH) t3 = t33.sum();
      const float xj = sX[sj * kLanes + lane];
      const float sring_j = sS[sj * kLanes + lane];
      const float sj23 = FULL ? fabsf(sring_j) : sring_j;
      const bool bcj = FULL && __float_as_int(sring_j) < 0;
      if (BAND == 0) __syncwarp();   // the next row reuses the only slot
      if (!kin) continue;
      const float what = !HIGH ? ring[BAND]
                         : FULL ? (bcj ? 0.f : xj * sj23)
                                : xj * (mxi * sj23);
      float acc = sSy[j - j0] * tv + sxi * (t2 + t3);
      if (sigma != 0.f) acc = acc + (sigma * sxi) * what;
      if (GRID) acc = grid_corrections(acc, sxi, cy, cz, i, j, k, NY, NZ);
      const float y = acc * (sxi * sj23);
      const float av =
          FULL ? (bcj ? xj : y)
               : xj * (1.f - mxi * (sMy[j - j0] * mzk)) + y * mxi;
      ok[j * NZ] = RESIDUAL ? rv - av : av;
    }
  }
}

enum T23Mode { kApply = 0, kResidual = 1, kCheb = 2 };

// kron_t23_m with the full bc lattice and three epilogues (see the head of
// this file). Unused pointers of a mode are null.
// HIGH: the tile of w^ and the bands of Kty and KtzT hold split_pack'ed
// values, and the sigma term recomputes w^ from v and s23.
template <int MODE, bool GRID, bool HIGH>
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
    sw[t] = keep<HIGH>(w);
  }
  for (int t = tid; t < D * kRows; t += kTK * kTR) {
    const int d = t / kRows, rj = t % kRows;
    const int j = j0 + rj, jj = j - band + d;
    sKy[t] = (j < NY && jj >= 0 && jj < NY)
                 ? keep<HIGH>(Kty[(int64_t)j * NY + jj])
                 : 0.f;
  }
  for (int t = tid; t < D * kTK; t += kTK * kTR) {
    const int d = t / kTK, kc = k0 + t % kTK, kk = kc - band + d;
    sKz[t] = (kc < NZ && kk >= 0 && kk < NZ)
                 ? keep<HIGH>(KtzT[(int64_t)kk * NZ + kc])
                 : 0.f;
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
    const float* srow = sw + (rj + band) * W + tx;
    if (HIGH) {   // _dot3(Kty, w^) and _dot3(w^, KtzT)
      Acc3 a2, a3;
      for (int d = 0; d < D; ++d)
        a2.add(sKy[d * kRows + rj], sw[(rj + d) * W + tx + band]);
      for (int d = 0; d < D; ++d) a3.add(srow[d], sKz[d * kTK + tx]);
      t2 = a2.sum();
      t3 = a3.sum();
    } else {
      for (int d = 0; d < D; ++d)
        t2 = fmaf(sKy[d * kRows + rj], sw[(rj + d) * W + tx + band], t2);
      for (int d = 0; d < D; ++d)
        t3 = fmaf(srow[d], sKz[d * kTK + tx], t3);
    }

    const int64_t o = (int64_t)j * NZ + k;
    const int64_t idx = (int64_t)i * plane + o;
    const float vv = vi_pl[o];
    const float what =
        HIGH ? (bci_pl[o] ? 0.f : vv * s23[o]) : srow[band];
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

// Calls fn(std::integral_constant<int, BAND>) for band in 0..MAX, each
// band its own instantiation; any other band is cudaErrorInvalidValue.
template <int MAX, int B = 0, class Fn>
int with_band(int band, Fn&& fn) {
  if constexpr (B > MAX) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (band == B) return fn(std::integral_constant<int, B>{});
    return with_band<MAX, B + 1>(band, fn);
  }
}

// The current device and its SM count, read from the runtime once per
// device.
struct Card {
  int dev, sms;
};
inline Card current_card() {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> sms[kMaxDevices];
  Card c{0, 0};
  cudaGetDevice(&c.dev);
  if (c.dev >= 0 && c.dev < kMaxDevices) c.sms = sms[c.dev].load();
  if (c.sms == 0) {
    cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, c.dev);
    if (c.dev >= 0 && c.dev < kMaxDevices) sms[c.dev].store(c.sms);
  }
  return c;
}

// The chunk a marching block covers along an axis of n planes, when one
// chunk layer of the grid has `layer` blocks, on a card of `sms` SMs. A
// short chunk pays its 2P-plane halo over fewer outputs, but a lattice
// too small to give every SM a block leaves the card idle and each
// thread's march one long dependent chain: on the H100 the 253^3 lattice
// measured best at 64 planes, 127^3 at 32, 64^3 at 8 or 4, 43^3 at 4 or
// 2 and 22^3 at 2.
inline int march_chunk(int n, int layer, int sms) {
  auto blocks = [&](int c) { return (int64_t)layer * ((n + c - 1) / c); };
  if (blocks(kLongChunk) >= 4 * sms) return kLongChunk;
  int c = kShortChunk;
  while (c > kMinChunk && blocks(c) < sms) c /= 2;
  return c;
}

// Warps of a block along z: the most, up to kWarps, that divide a row's
// warps evenly, so a block reads whole contiguous rows and none of its
// warps lies wholly past the lattice (129 columns take 1, not 8 warps).
inline int march_kw(int NZ) {
  const int row_warps = (NZ + kLanes - 1) / kLanes;
  int kw = kWarps;
  while (kw > 1 && row_warps % kw != 0) kw /= 2;
  return kw;
}

inline dim3 march_grid(int NZ, int across, int n, int chunk, int kw) {
  const int rows = kWarps / kw;
  return dim3((unsigned)((NZ + kw * kLanes - 1) / (kw * kLanes)),
              (unsigned)((across + rows - 1) / rows),
              (unsigned)((n + chunk - 1) / chunk));
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel
// and device; `granted` keeps a bit per device already opted in to
// `bytes`, so a launch makes no runtime call for it after the first.
template <class Kernel>
int allow_smem(Kernel kern, size_t bytes, int dev,
               std::atomic<uint64_t>& granted) {
  if (bytes <= 48 * 1024) return 0;
  const uint64_t bit = dev >= 0 && dev < 64 ? uint64_t{1} << dev : 0;
  if (bit != 0 && (granted.load() & bit) != 0) return 0;
  const int rc = (int)cudaFuncSetAttribute(
      (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (rc == 0) granted.fetch_or(bit);
  return rc;
}

// kron_t1_m's shared memory (the chunk's Ktx band) stays under the default.
static_assert(sizeof(float) * kLongChunk * band_pad(kMaxBand) <= 48 * 1024,
              "kron_t1_m needs no shared-memory opt-in");

template <bool FULL>
int launch_t1_m(const float* x, const float* myb, const uint8_t* bc,
                const float* Ktx, const float* sxz, float* out, int NX,
                int NY, int NZ, int band, cudaStream_t stream) {
  const int kw = march_kw(NZ);
  const dim3 layer = march_grid(NZ, NY, 1, 1, kw);
  const int chunk = march_chunk(NX, layer.x * layer.y, current_card().sms);
  return with_band<kMaxBand>(band, [&](auto b) {
    constexpr int B = decltype(b)::value;
    const size_t smem = sizeof(float) * chunk * band_pad(B);
    kron_t1_m<B, FULL, kHigh><<<march_grid(NZ, NY, NX, chunk, kw),
                         dim3(kLanes, kWarps), smem, stream>>>(
        x, myb, bc, Ktx, sxz, out, NX, NY, NZ, chunk, kw);
    return (int)cudaGetLastError();
  });
}

// Kernel 2 in its four forms (apply or residual, with or without the
// shard corrections): separable over bands 0..kMaxBand, FULL over bands
// 0..kT23MarchMaxBand.
template <bool FULL>
int launch_t23_m(const float* x, const float* mx2, const uint8_t* bc,
                 const float* t1, const float* Kty, const float* KtzT,
                 const float* sx2d, const float* sycol, const float* s23m,
                 const float* myb, const float* mzrow, const float* cy,
                 const float* cz, const float* r, float* out, int NX, int NY,
                 int NZ, int band, float sigma, cudaStream_t stream) {
  const int kw = march_kw(NZ);
  const dim3 layer = march_grid(NZ, NX, 1, 1, kw);
  const Card card = current_card();
  const int chunk = march_chunk(NY, layer.x * layer.y, card.sms);
  const bool grid = cy != nullptr || cz != nullptr;
  constexpr int kMax = FULL ? kT23MarchMaxBand : kMaxBand;
  return with_band<kMax>(band, [&](auto b) {
    constexpr int B = decltype(b)::value;
    auto kern = r == nullptr
        ? (grid ? kron_t23_m<B, false, true, FULL, kHigh>
                : kron_t23_m<B, false, false, FULL, kHigh>)
        : (grid ? kron_t23_m<B, true, true, FULL, kHigh>
                : kron_t23_m<B, true, false, FULL, kHigh>);
    // One opt-in per variant and device, for the longest chunk.
    static std::atomic<uint64_t> granted[2][2];
    if (int rc = allow_smem(kern, t23_m_smem(B, kLongChunk), card.dev,
                            granted[r != nullptr][grid]))
      return rc;
    const size_t smem = t23_m_smem(B, chunk);
    kern<<<march_grid(NZ, NX, NY, chunk, kw), dim3(kLanes, kWarps), smem,
           stream>>>(x, mx2, bc, t1, Kty, KtzT, sx2d, sycol, s23m, myb, mzrow,
                     cy, cz, r, out, NX, NY, NZ, chunk, kw, sigma);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

int kron_max_band() { return kMaxBand; }

// 1 in the precision="high" library (built with -DPMG_HIGH=1), else 0.
int kron_high() { return kHigh ? 1 : 0; }

int kron_t1_m_launch(const float* x, const float* myb, const float* Ktx,
                     const float* sxzm, float* out, int NX, int NY, int NZ,
                     int band, void* stream) {
  return launch_t1_m<false>(x, myb, nullptr, Ktx, sxzm, out, NX, NY, NZ,
                            band, (cudaStream_t)stream);
}

// r == nullptr: out = A x (kernel #2); otherwise out = r - A x (kernel #3).
// With cy or cz (either may be null): kernel #9 in the same two forms.
int kron_t23_m_launch(const float* x, const float* mx2, const float* t1,
                      const float* Kty, const float* KtzT, const float* sx2d,
                      const float* sycol, const float* s23m, const float* myb,
                      const float* mzrow, const float* cy, const float* cz,
                      const float* r, float* out, int NX, int NY, int NZ,
                      int band, float sigma, void* stream) {
  return launch_t23_m<false>(x, mx2, nullptr, t1, Kty, KtzT, sx2d, sycol,
                             s23m, myb, mzrow, cy, cz, r, out, NX, NY, NZ,
                             band, sigma, (cudaStream_t)stream);
}

int kron_t1_launch(const float* x, const uint8_t* bc, const float* Ktx,
                   const float* sxz, float* out, int NX, int NY, int NZ,
                   int band, void* stream) {
  return launch_t1_m<true>(x, nullptr, bc, Ktx, sxz, out, NX, NY, NZ, band,
                           (cudaStream_t)stream);
}

// r == nullptr: out = A v (kernel #5); otherwise out = r - A v (kernel #6).
// With cy or cz (either may be null): kernel #8 in the same two forms.
// march != 0: the y-march kron_t23_m<B, R, G, true> (bands up to
// kT23MarchMaxBand); march == 0: the tile kron_t23<kApply|kResidual, G>.
int kron_t23_launch(const float* v, const uint8_t* bc, const float* t1,
                    const float* Kty, const float* KtzT, const float* sx2d,
                    const float* sycol, const float* s23, const float* cy,
                    const float* cz, const float* r, float* out, int NX,
                    int NY, int NZ, int band, float sigma, int march,
                    void* stream) {
  if (march)
    return launch_t23_m<true>(v, nullptr, bc, t1, Kty, KtzT, sx2d, sycol,
                              s23, nullptr, nullptr, cy, cz, r, out, NX, NY,
                              NZ, band, sigma, (cudaStream_t)stream);
  if (band < 0 || band > kMaxBand) return (int)cudaErrorInvalidValue;
  const bool grid = cy != nullptr || cz != nullptr;
  auto kern = r == nullptr
      ? (grid ? kron_t23<kApply, true, kHigh> : kron_t23<kApply, false, kHigh>)
      : (grid ? kron_t23<kResidual, true, kHigh>
              : kron_t23<kResidual, false, kHigh>);
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
  kron_t23<kCheb, false, kHigh><<<tile_grid(NZ, NY, NX), dim3(kTK, kTR),
                           t23_smem(band), (cudaStream_t)stream>>>(
      v, bc, t1, Kty, KtzT, sx2d, sycol, s23, nullptr, nullptr, r, x, dinv,
      lmax, kstep, ro, xo, zo, NX, NY, NZ, band, sigma);
  return (int)cudaGetLastError();
}

}  // extern "C"
