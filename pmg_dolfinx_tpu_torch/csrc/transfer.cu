// Hand-written Hopper (sm_90a) kernels for the fused per-axis p-transfers.
//
// Replaces the Pallas kernels of pmg_dolfinx_tpu/ops/pallas_transfer.py:
//   transfer_x<W, C>, transfer_x_direct
//                   <- _kernel_tx    t[a, y, z] = sum_x Mx[a, x] x3[x, y, z]
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
// 1. transfer_x<W, C>: a thread owns C (y, z) columns of x3 and marches
//    them along x, reading each row of its range once (a warp reads 128
//    contiguous bytes of a row) into a register ring of the last W rows,
//    max(W, kAhead) rows ahead of their use. A block takes a segment of S
//    output rows a in the stable order of their ranges' ends hi (the
//    layout transfer_yz uses, ops/transfer.py:_yz_rows) and marches only
//    the union of their ranges; when the march reaches hi - 1 of the next
//    row in order, the thread sums t[a] = sum_x Mx[a, x] x3[x] over the
//    ring (the row's W coefficients in shared memory, read as float4
//    broadcasts) and writes it, coalesced. The plane of a V-cycle's
//    transfer has 1,849 to 64,009 columns, too few threads to hide a
//    march's latency, so the rows are cut into segments until the launch
//    fills the card (ops/transfer.py:x_plan; neighbouring segments share
//    a few rows of x3, through L2), and a thread marches C = 2 or 4
//    columns kThreads apart, so each step has C loads in flight. The
//    march is transfer_yz's y march (march_rows below), so W is the same
//    template parameter: 4, 8, 12, 16, and 0 for a runtime-length sum
//    over each row's range. Where 8-row segments cannot give every SM two
//    blocks (the p 1 <-> 3 transfers: 1,849 or 16,129 columns by 43 or
//    127 rows), a march's latency shows and the plan takes the direct
//    form, transfer_x_direct: a thread per output, each row of x3 read
//    from L2 by every output row whose range covers it (~6.5 times on a
//    p 6 -> 3 restriction), the kernel the march replaced. Both sum the
//    same terms in the same order, so the results are its bits.
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
constexpr int kMaxSeg = 64;             // output rows a per transfer_x block
constexpr int kAhead = 8;               // rows of t a lane's loads run ahead
constexpr int kMaxSmem = 227 * 1024;    // dynamic shared memory per block

// Shared memory of a transfer_yz block: u [RB][NZ], the MzT band [W][C],
// the rows' My coefficients [RB][W], then the rows' b, lo, hi [RB] and
// the columns' lo, length [C]. ops/transfer.py:yz_smem mirrors it.
__host__ __device__ constexpr size_t yz_smem(int W, int RB, int NZ, int C) {
  return sizeof(float) * ((size_t)RB * NZ + (size_t)W * C + (size_t)RB * W) +
         sizeof(int) * (3 * (size_t)RB + 2 * (size_t)C);
}

// The march of C columns (col + c * cstep, c < C) over the rows [r0, r1)
// of a block, taken in the order of their ranges' ends hi: for each row r
// and column c, sink(r, c, sum over v in [lo, hi) of M[row, v] col[c *
// cstep + v * stride]), the sum from 0 in fmaf, v ascending. A column's
// values pass through a register ring of the last W (W >= every range)
// and are loaded max(W, kAhead) ahead; sM[r][d] = M[row, hi - W + d],
// zero (and skipped) below lo. W = 0: runtime-length sums over the rows of
// M (K columns) read from L1/L2. Bit c of `in` is clear for a column past
// the lattice: it marches zeros and its sink must not store.
template <int W, int C, class Sink>
__device__ __forceinline__ void march_rows(
    const float* __restrict__ col, int cstep, int stride,
    const float* __restrict__ M, int K, const float* sM, const int* sRow,
    const int* sLo, const int* sHi, unsigned in, int r0, int r1, Sink sink) {
  if constexpr (W == 0) {
    for (int r = r0; r < r1; ++r) {
      const int lo = sLo[r], hi = sHi[r];
      if (hi <= lo) continue;
      const float* row = M + (int64_t)sRow[r] * K;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const bool cin = (in >> c) & 1u;
        float acc = 0.f;
        for (int v = lo; v < hi; ++v)
          acc = fmaf(row[v], cin ? col[c * cstep + v * stride] : 0.f, acc);
        sink(r, c, acc);
      }
    }
  } else {
    constexpr int U = W < kAhead ? kAhead : W;   // a multiple of W
    int vlo = K, vhi = 0;
    for (int r = r0; r < r1; ++r) {
      if (sLo[r] < sHi[r]) {
        vlo = min(vlo, sLo[r]);
        vhi = max(vhi, sHi[r]);
      }
    }
    // Empty rows (lo = hi = 0) sort first and are never summed; rows past
    // the matrix (hi = 0) come last, after every nonempty row, so the
    // march ends before it reaches them.
    int q = r0;
    while (q < r1 && sHi[q] == 0) ++q;
    int qhi = q < r1 ? sHi[q] : -1;   // the end of row q's range
    float ring[C][W], pf[C][U];   // ring[c][(v - vlo) % W] = column c at v
    auto load = [&](int c, int v) {
      return ((in >> c) & 1u) && v < vhi ? col[c * cstep + v * stride] : 0.f;
    };
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int s = 0; s < W; ++s) ring[c][s] = 0.f;
#pragma unroll
      for (int s = 0; s < U; ++s) pf[c][s] = load(c, vlo + s);
    }
    for (int vb = vlo; vb < vhi; vb += U) {
#pragma unroll
      for (int s = 0; s < U; ++s) {
        const int v = vb + s;
        if (v >= vhi) break;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          ring[c][s % W] = pf[c][s];
          pf[c][s] = load(c, v + U);
        }
        // Rows whose range ends at v: sM[q][d] = M[row, v + 1 - W + d].
        for (; qhi == v + 1; qhi = ++q < r1 ? sHi[q] : -1) {
          const int skip = W - (qhi - sLo[q]);
          const float4* c4 = reinterpret_cast<const float4*>(sM + q * W);
          float acc[C];
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll
          for (int e = 0; e < W / 4; ++e) {
            const float4 k4 = c4[e];
            const float ks[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
            for (int f = 0; f < 4; ++f) {
              const int d = 4 * e + f;
              if (d >= skip) {
#pragma unroll
                for (int c = 0; c < C; ++c)
                  acc[c] = fmaf(ks[f], ring[c][(s + 1 + d) % W], acc[c]);
              }
            }
          }
#pragma unroll
          for (int c = 0; c < C; ++c) sink(q, c, acc[c]);
        }
      }
    }
  }
}

// Shared memory of a transfer_x block: the segment's coefficients [S][W]
// and its rows' row, lo, hi [S].
__host__ __device__ constexpr size_t x_smem(int W, int S) {
  return sizeof(float) * (size_t)S * W + sizeof(int) * 3 * (size_t)S;
}

// A block: S output rows by kThreads * C columns, column c of a thread at
// p0 + c * kThreads, so each step of the march reads C coalesced pieces of
// a row of x3.
template <int W, int C>
__global__ void __launch_bounds__(kThreads)
transfer_x(const float* __restrict__ x3, const float* __restrict__ Mx,
           const int* __restrict__ xrows, const float* __restrict__ xcoef,
           float* __restrict__ t, int NX, int NYZ, int A, int S) {
  extern __shared__ float4 smem4[];
  float* sMx = reinterpret_cast<float*>(smem4);       // [S][W] Mx, by hi
  int* sRow = reinterpret_cast<int*>(sMx + S * W);    // [S] a (-1 past A)
  int* sLo = sRow + S;                                // [S] its x range
  int* sHi = sLo + S;
  const int tid = threadIdx.x, q0 = blockIdx.y * S;
  for (int r = tid; r < S; r += kThreads) {
    const bool in = q0 + r < A;
    sRow[r] = in ? xrows[q0 + r] : -1;
    sLo[r] = in ? xrows[A + q0 + r] : 0;
    sHi[r] = in ? xrows[2 * A + q0 + r] : 0;
  }
  if constexpr (W > 0) {
    const float4* c4 = reinterpret_cast<const float4*>(xcoef) + q0 * W / 4;
    float4* s4 = reinterpret_cast<float4*>(sMx);
    const int n4 = (min(S, A - q0) * W) / 4;
    for (int i = tid; i < S * W / 4; i += kThreads)
      s4[i] = i < n4 ? c4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  const int64_t p0 = (int64_t)blockIdx.x * kThreads * C + tid;
  unsigned in = 0;
#pragma unroll
  for (int c = 0; c < C; ++c)
    in |= (p0 + c * kThreads < NYZ ? 1u : 0u) << c;
  auto sink = [&](int r, int c, float acc) {
    if ((in >> c) & 1u) t[(int64_t)sRow[r] * NYZ + p0 + c * kThreads] = acc;
  };
  for (int r = 0; r < S; ++r)   // all-zero rows of Mx: t[a] = 0
    if (sRow[r] >= 0 && sHi[r] <= sLo[r]) {
#pragma unroll
      for (int c = 0; c < C; ++c) sink(r, c, 0.f);
    }
  march_rows<W, C>(x3 + (in ? p0 : 0), kThreads, NYZ, Mx, NX, sMx, sRow,
                   sLo, sHi, in, 0, S, sink);
}

// The direct form, for planes too small to fill the card with marches: a
// thread per output (row q in hi order, column p), summing its row's range
// from L1/L2 (the kernel the march replaced, in the same order). Blocks
// of neighbouring rows are launched next to each other (q is blockIdx.x),
// so the x3 rows their ranges share are read from L2.
__global__ void __launch_bounds__(kThreads)
transfer_x_direct(const float* __restrict__ x3, const float* __restrict__ Mx,
                  const int* __restrict__ xrows, float* __restrict__ t,
                  int NX, int NYZ, int A) {
  const int q = blockIdx.x;
  const int64_t p = (int64_t)blockIdx.y * kThreads + threadIdx.x;
  if (p >= NYZ) return;
  const int a = xrows[q];
  const float* row = Mx + (int64_t)a * NX;
  float acc = 0.f;
  for (int v = xrows[A + q]; v < xrows[2 * A + q]; ++v)
    acc = fmaf(row[v], x3[(int64_t)v * NYZ + p], acc);
  t[(int64_t)a * NYZ + p] = acc;
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
    const int z = seg * kLanes + lane;
    const bool zin = z < NZ;
    march_rows<W, 1>(ta + (zin ? z : 0), 0, NZ, My, NY, sMy, sRow, sLo, sHi,
                     zin ? 1u : 0u, g * rows, (g + 1) * rows,
                     [&](int r, int, float acc) {
                       if (zin) sU[r * NZ + z] = acc;
                     });
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

// t (A, NY*NZ) = Mx (A, NX) contracted with x3 (NX, NY*NZ) along x.
// xrows (3, A): the rows of Mx in the stable order of their ranges' ends
// hi, then each one's lo and hi; xcoef (A, W): row xrows[0][q]'s Mx[a, hi
// - W + d], zero below lo (unused for W = 0). The plan: W the ring width
// (4, 8, 12 or 16, at least the widest range; 0 for any width), S the
// rows per block (1 to kMaxSeg) and C the columns per thread (1, 2 or 4),
// as ops/transfer.py:x_plan picks them; S = 0 launches the direct form
// (W and C unused).
int transfer_x_launch(const float* x3, const float* Mx, const int* xrows,
                      const float* xcoef, float* t, int NX, int NYZ, int A,
                      int W, int S, int C, void* stream) {
  if ((int64_t)NX * NYZ >= (int64_t{1} << 31))
    return (int)cudaErrorInvalidValue;
  if (S == 0) {
    if ((NYZ + kThreads - 1) / kThreads > 65535)
      return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)A, (unsigned)((NYZ + kThreads - 1) / kThreads));
    transfer_x_direct<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        x3, Mx, xrows, t, NX, NYZ, A);
    return (int)cudaGetLastError();
  }
  if (C != 1 && C != 2 && C != 4) return (int)cudaErrorInvalidValue;
  const int64_t cols = ((int64_t)NYZ + kThreads * C - 1) / (kThreads * C);
  if (S < 0 || S > kMaxSeg || cols > 0x7fffffff || (A + S - 1) / S > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)cols, (unsigned)((A + S - 1) / S));
  auto launch = [&](auto kernel_width, auto columns) {
    constexpr int kW = decltype(kernel_width)::value;
    constexpr int kC = decltype(columns)::value;
    transfer_x<kW, kC><<<grid, kThreads, x_smem(kW, S),
                         (cudaStream_t)stream>>>(x3, Mx, xrows, xcoef, t, NX,
                                                 NYZ, A, S);
    return (int)cudaGetLastError();
  };
  auto widths = [&](auto columns) {
    switch (W) {
      case 0: return launch(std::integral_constant<int, 0>{}, columns);
      case 4: return launch(std::integral_constant<int, 4>{}, columns);
      case 8: return launch(std::integral_constant<int, 8>{}, columns);
      case 12: return launch(std::integral_constant<int, 12>{}, columns);
      case 16: return launch(std::integral_constant<int, 16>{}, columns);
      default: return (int)cudaErrorInvalidValue;
    }
  };
  if (C == 1) return widths(std::integral_constant<int, 1>{});
  if (C == 2) return widths(std::integral_constant<int, 2>{});
  return widths(std::integral_constant<int, 4>{});
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
