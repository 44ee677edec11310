// Hand-written Hopper (sm_90a) kernels for the fused per-axis p-transfers.
//
// Replaces the Pallas kernels of pmg_dolfinx_tpu/ops/pallas_transfer.py:
//   transfer_x      <- _kernel_tx    t[a, y, z] = sum_x Mx[a, x] x3[x, y, z]
//   transfer_yz<W>  <- _kernel_tyz   out[a]     = My @ t[a] @ MzT
// so that, as on the TPU, the x-contracted lattice t is the only
// intermediate that reaches device memory. Restriction passes (Ix^T, Iy^T,
// Iz), prolongation (Ix, Iy, Iz^T) (ops/transfer.py:transfer_mats).
//
// What bounds it on this card. The matrices are the per-axis GLL
// interpolation matrices: block-sparse, Pc+1 nonzeros in a fine row and at
// most 2 Pf + 1 in a coarse one. Summed over those only, a transfer does a
// few tens of FMAs per output and is bound by its bytes: x3 read, t
// written and read, out written. At p 6 -> 3 on 253^3 -> 127^3 that is
// ~138 MB (0.041 ms at 3.35 TB/s), at 3 -> 6 ~106 MB; the dense products
// of the TPU kernels would do 253 FMAs per output and term.
//
// Design.
// 1. transfer_x: a block owns one output row a and 256 consecutive points
//    of the (y, z) plane; each thread sums its point over the row's
//    nonzero range [lo, hi) of Mx. Reads of x3 and writes of t coalesce;
//    Mx[a, x] is the same for the whole block. Blocks of neighbouring a
//    are launched next to each other (a is blockIdx.x), so the x3 rows two
//    of them share are read from L2.
// 2. transfer_yz: a block of 8 warps owns one a-slab and RB output rows b,
//    taken in the order of their ranges' ends hi (a stable sort of hi;
//    the identity for most matrices), and works in two phases with one
//    barrier between them. Its operands are laid out once per matrix
//    (ops/transfer.py: _yz_rows, _yz_band), so a block stages them with
//    contiguous, independent loads.
//    y: a lane owns one z column and marches along y over the union of
//    its rows' ranges, reading t[a, y, z] once (a warp reads 128
//    contiguous bytes of a row), max(W, kAhead) rows ahead of its use,
//    into a register ring of the last W rows (W >= the widest range, a
//    template parameter, so every ring slot is a compile-time register).
//    When the march reaches hi - 1 of the next row b in order, the lane
//    sums u[b][z] = sum_y My[b, y] t[a, y, z] over the ring, the row's
//    coefficients in shared memory read as float4 broadcasts, and writes
//    u into the block's shared rows. There is no barrier in the march:
//    each lane writes only its own column. When a row of t is shorter
//    than 8 warps of lanes, the block's rows are split between groups of
//    warps, each marching its own rows.
//    z: after the barrier, a warp takes 32 output columns c, keeps their
//    compact band of MzT (W coefficients per column, staged once per
//    block) in registers and sums out[a, b, c] = sum_z u[b][z] MzT[z, c]
//    over c's range for its share of the rows; each output row is
//    written in whole 128-byte pieces.
//    A range wider than the widest template (16) launches W = 0: the same
//    two phases with runtime-length sums, reading t and MzT from L1/L2.
//    Rows of t are 253, 127 or 43 floats on the V-cycle, not 16-byte
//    aligned, so the loads are 4-byte, a whole 128-byte line per warp.
//    What holds it at ~40% of its bound on the V-cycle's large shapes is
//    the instruction rate of the march and of the two contractions' sums
//    (W predicated FMAs each), with 4-5 blocks of 8 warps per SM (64 and
//    48 registers at W = 12 and 4; ptxas): the register count sets the
//    occupancy, and W = 16 (80 registers, 3 blocks) ran slower than 12.
// The ranges come from the matrices themselves (ops/transfer.py:
// nonzero_ranges), so the kernels compute the dense product for any
// matrices; only the order of addition differs (y ascending, then z
// ascending, in true f32 FMA: precision="highest"). transfer_yz keeps the
// order, and so the bits, of the kernel it replaced: each sum starts from
// 0 and adds its range in ascending order, in fmaf.
//
// Every C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (cudaErrorInvalidValue for a launch plan
// the kernel does not take) so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 32;
constexpr int kMaxRows = 32;            // output rows b per transfer_yz block
constexpr int kAhead = 8;               // rows of t a lane's loads run ahead
constexpr int kMaxSmem = 227 * 1024;    // dynamic shared memory per block

__global__ void __launch_bounds__(kThreads)
transfer_x(const float* __restrict__ x3, const float* __restrict__ Mx,
           const int* __restrict__ rx, float* __restrict__ t, int NX,
           int NYZ, int A) {
  const int a = blockIdx.x;
  const int p = blockIdx.y * kThreads + threadIdx.x;
  if (p >= NYZ) return;
  const float* row = Mx + (int64_t)a * NX;
  float acc = 0.f;
  for (int x = rx[a]; x < rx[A + a]; ++x)
    acc = fmaf(row[x], x3[(int64_t)x * NYZ + p], acc);
  t[(int64_t)a * NYZ + p] = acc;
}

// Shared memory of a transfer_yz block: u [RB][NZ], the MzT band [W][C],
// the rows' My coefficients [RB][W], then the rows' b, lo, hi [RB] and
// the columns' lo, length [C]. ops/transfer.py:yz_smem mirrors it.
__host__ __device__ constexpr size_t yz_smem(int W, int RB, int NZ, int C) {
  return sizeof(float) * ((size_t)RB * NZ + (size_t)W * C + (size_t)RB * W) +
         sizeof(int) * (3 * (size_t)RB + 2 * (size_t)C);
}

// The y phase of one lane (column z) over the block's rows [r0, r1), in
// hi order: u[r][z] = sum over y in [lo, hi) of My[b, y] t[a, y, z].
template <int W>
__device__ __forceinline__ void yz_rows(
    const float* __restrict__ ta, const float* __restrict__ My, float* sU,
    const float* sMy, const int* sRow, const int* sLo, const int* sHi,
    int z, int NY, int NZ, int r0, int r1) {
  const bool zin = z < NZ;
  const float* tz = ta + (zin ? z : 0);
  if constexpr (W == 0) {
    for (int r = r0; r < r1; ++r) {
      const int lo = sLo[r], hi = sHi[r];
      if (hi <= lo) continue;
      const float* row = My + (int64_t)sRow[r] * NY;
      float acc = 0.f;
      for (int y = lo; y < hi; ++y)
        acc = fmaf(row[y], zin ? tz[y * NZ] : 0.f, acc);
      if (zin) sU[r * NZ + z] = acc;
    }
  } else {
    constexpr int U = W < kAhead ? kAhead : W;   // a multiple of W
    int ylo = NY, yhi = 0;
    for (int r = r0; r < r1; ++r) {
      if (sLo[r] < sHi[r]) {
        ylo = min(ylo, sLo[r]);
        yhi = max(yhi, sHi[r]);
      }
    }
    // Empty rows (lo = hi = 0) sort first and are never summed (their u
    // is not read); rows past B (hi = 0) come last, after every nonempty
    // row, so the march ends before it reaches them.
    int q = r0;
    while (q < r1 && sHi[q] == 0) ++q;
    int qhi = q < r1 ? sHi[q] : -1;   // the end of row q's range
    float ring[W], pf[U];   // ring[(y - ylo) % W] = t[a, y, z]
#pragma unroll
    for (int s = 0; s < W; ++s) ring[s] = 0.f;
#pragma unroll
    for (int s = 0; s < U; ++s)
      pf[s] = zin && ylo + s < yhi ? tz[(ylo + s) * NZ] : 0.f;
    for (int yb = ylo; yb < yhi; yb += U) {
#pragma unroll
      for (int s = 0; s < U; ++s) {
        const int y = yb + s;
        if (y >= yhi) break;
        ring[s % W] = pf[s];
        pf[s] = zin && y + U < yhi ? tz[(y + U) * NZ] : 0.f;
        // Rows whose range ends at y: sMy[q][d] = My[b, y + 1 - W + d],
        // zero (and skipped) below lo.
        for (; qhi == y + 1; qhi = ++q < r1 ? sHi[q] : -1) {
          const int skip = W - (qhi - sLo[q]);
          const float4* c4 = reinterpret_cast<const float4*>(sMy + q * W);
          float acc = 0.f;
#pragma unroll
          for (int e = 0; e < W / 4; ++e) {
            const float4 c = c4[e];
            const float cs[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
            for (int f = 0; f < 4; ++f) {
              const int d = 4 * e + f;
              if (d >= skip) acc = fmaf(cs[f], ring[(s + 1 + d) % W], acc);
            }
          }
          if (zin) sU[q * NZ + z] = acc;
        }
      }
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
transfer_yz(const float* __restrict__ t, const float* __restrict__ My,
            const int* __restrict__ yrows, const float* __restrict__ ycoef,
            const float* __restrict__ MzT, const int* __restrict__ rz,
            const float* __restrict__ zband, float* __restrict__ out, int NY,
            int NZ, int B, int C, int RB) {
  extern __shared__ float4 smem4[];
  float* sU = reinterpret_cast<float*>(smem4);       // [RB][NZ] u rows
  float* sKz = sU + RB * NZ;                          // [W][C] MzT band
  float* sMy = sKz + W * C;                           // [RB][W] My, by hi
  int* sRow = reinterpret_cast<int*>(sMy + RB * W);   // [RB] b (-1 past B)
  int* sLo = sRow + RB;                               // [RB] its y range
  int* sHi = sLo + RB;
  int* sLoZ = sHi + RB;                               // [C] c's z range
  int* sLenZ = sLoZ + C;
  const int tid = threadIdx.x, lane = tid % kLanes, warp = tid / kLanes;
  const int a = blockIdx.y, p0 = blockIdx.x * RB;
  // Stage the block's rows and the bands: contiguous copies of operands
  // laid out once per matrix (ops/transfer.py:_yz_operands), so no load
  // waits on another.
  for (int r = tid; r < RB; r += kThreads) {
    const bool in = p0 + r < B;
    sRow[r] = in ? yrows[p0 + r] : -1;
    sLo[r] = in ? yrows[B + p0 + r] : 0;
    sHi[r] = in ? yrows[2 * B + p0 + r] : 0;
  }
  for (int c = tid; c < C; c += kThreads) {
    const int lo = rz[c];
    sLoZ[c] = lo;
    sLenZ[c] = rz[C + c] - lo;
  }
  if constexpr (W > 0) {
    const float4* cy4 = reinterpret_cast<const float4*>(ycoef) + p0 * W / 4;
    float4* sMy4 = reinterpret_cast<float4*>(sMy);
    const int ny4 = (min(RB, B - p0) * W) / 4;
    for (int i = tid; i < RB * W / 4; i += kThreads)
      sMy4[i] = i < ny4 ? cy4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* kz4 = reinterpret_cast<const float4*>(zband);
    float4* sKz4 = reinterpret_cast<float4*>(sKz);
    for (int i = tid; i < W * C / 4; i += kThreads) sKz4[i] = kz4[i];
  }
  __syncthreads();

  // y: (z segment of 32 columns, group of rows) per warp.
  const float* ta = t + (int64_t)a * NY * NZ;
  const int nseg = (NZ + kLanes - 1) / kLanes;
  int groups = 1;
  while (groups < RB && 2 * groups * nseg <= kWarps) groups *= 2;
  const int rows = RB / groups;
  for (int item = warp; item < nseg * groups; item += kWarps) {
    const int seg = item % nseg, g = item / nseg;
    yz_rows<W>(ta, My, sU, sMy, sRow, sLo, sHi, seg * kLanes + lane, NY, NZ,
               g * rows, (g + 1) * rows);
  }
  __syncthreads();

  // z: a warp takes 32 output columns c, loads their band into registers,
  // and sums them for its share of the rows: out[a, b, c] = sum over z in
  // c's range of u[b][z] MzT[z, c].
  float* oa = out + (int64_t)a * B * C;
  const int npass = (C + kLanes - 1) / kLanes;
  const int rstep = RB < kWarps ? RB : kWarps;   // warps on one pass
  for (int pass = warp / rstep; pass < npass; pass += kWarps / rstep) {
    const int c = pass * kLanes + lane;
    const bool cin = c < C;
    const int lo = cin ? sLoZ[c] : 0, len = cin ? sLenZ[c] : 0;
    float kz[W > 0 ? W : 1];
    if constexpr (W > 0) {
#pragma unroll
      for (int d = 0; d < W; ++d) kz[d] = cin ? sKz[d * C + c] : 0.f;
    }
    for (int r = warp % rstep; r < RB; r += rstep) {
      const int b = sRow[r];
      if (b < 0 || !cin) continue;
      float acc = 0.f;
      if (sLo[r] < sHi[r]) {   // an all-zero row of My gives u = 0, out = 0
        const float* u = sU + r * NZ + lo;
        if constexpr (W == 0) {
          const float* m = MzT + (int64_t)lo * C + c;
          for (int d = 0; d < len; ++d)
            acc = fmaf(u[d], m[(int64_t)d * C], acc);
        } else {
#pragma unroll
          for (int d = 0; d < W; ++d)
            if (d < len) acc = fmaf(u[d], kz[d], acc);
        }
      }
      oa[(int64_t)b * C + c] = acc;
    }
  }
}

// Opt a transfer_yz instantiation in to the most dynamic shared memory,
// once per device (a bit of `granted` per device).
template <int W>
int launch_yz(const float* t, const float* My, const int* yrows,
              const float* ycoef, const float* MzT, const int* rz,
              const float* zband, float* out, int A, int NY, int NZ, int B,
              int C, int RB, cudaStream_t stream) {
  static std::atomic<uint64_t> granted{0};
  const size_t smem = yz_smem(W, RB, NZ, C);
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaGetDevice(&dev);
    const uint64_t bit = dev >= 0 && dev < 64 ? uint64_t{1} << dev : 0;
    if (bit == 0 || (granted.load() & bit) == 0) {
      const cudaError_t err = cudaFuncSetAttribute(
          transfer_yz<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxSmem);
      if (err != cudaSuccess) return (int)err;
      granted.fetch_or(bit);
    }
  }
  const dim3 grid((unsigned)((B + RB - 1) / RB), (unsigned)A);
  transfer_yz<W><<<grid, kThreads, smem, stream>>>(
      t, My, yrows, ycoef, MzT, rz, zband, out, NY, NZ, B, C, RB);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// t (A, NY*NZ) = Mx (A, NX) contracted with x3 (NX, NY*NZ) along x; rx is
// (2, A): the [lo, hi) nonzero range of each row of Mx.
int transfer_x_launch(const float* x3, const float* Mx, const int* rx,
                      float* t, int NX, int NYZ, int A, void* stream) {
  const dim3 grid((unsigned)A, (unsigned)((NYZ + kThreads - 1) / kThreads));
  transfer_x<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x3, Mx, rx, t, NX,
                                                          NYZ, A);
  return (int)cudaGetLastError();
}

// out (A, B, C) = My (B, NY) t[a] (NY, NZ) MzT (NZ, C) for every a.
// yrows (3, B): the rows of My in the stable order of their ranges' ends
// hi, then each one's lo and hi; ycoef (B, W): row yrows[0][p]'s
// My[b, hi - W + d], zero below lo; rz (2, C): the [lo, hi) range of each
// column of MzT; zband (W, C): MzT[lo + d, c], zero past hi. The plan: W
// the ring width (4, 8, 12 or 16, at least the widest range; 0 for any
// width, ycoef and zband unused) and RB the rows per block (a power of
// two up to 32), as ops/transfer.py:yz_plan picks them.
int transfer_yz_launch(const float* t, const float* My, const int* yrows,
                       const float* ycoef, const float* MzT, const int* rz,
                       const float* zband, float* out, int A, int NY, int NZ,
                       int B, int C, int W, int RB, void* stream) {
  if (RB <= 0 || RB > kMaxRows || (RB & (RB - 1)) != 0 || A > 65535 ||
      (int64_t)NY * NZ >= (int64_t{1} << 31) ||
      yz_smem(W, RB, NZ, C) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  auto launch = [&](auto kernel_width) {
    constexpr int kW = decltype(kernel_width)::value;
    return launch_yz<kW>(t, My, yrows, ycoef, MzT, rz, zband, out, A, NY, NZ,
                         B, C, RB, (cudaStream_t)stream);
  };
  switch (W) {
    case 0: return launch(std::integral_constant<int, 0>{});
    case 4: return launch(std::integral_constant<int, 4>{});
    case 8: return launch(std::integral_constant<int, 8>{});
    case 12: return launch(std::integral_constant<int, 12>{});
    case 16: return launch(std::integral_constant<int, 16>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// Blocks of transfer_yz<W> one SM holds at a plan's shared memory (the
// occupancy API, from ptxas's registers), or -1 for a W not compiled.
int transfer_yz_blocks_per_sm(int W, int RB, int NZ, int C) {
  int n = -1;
  const size_t smem = yz_smem(W, RB, NZ, C);
  auto query = [&](auto kern) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads, smem);
  };
  switch (W) {
    case 0: query(transfer_yz<0>); break;
    case 4: query(transfer_yz<4>); break;
    case 8: query(transfer_yz<8>); break;
    case 12: query(transfer_yz<12>); break;
    case 16: query(transfer_yz<16>); break;
    default: break;
  }
  return n;
}

}  // extern "C"
