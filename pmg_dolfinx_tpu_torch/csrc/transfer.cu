// Hand-written Hopper (sm_90a) kernels for the fused per-axis p-transfers.
//
// Replaces the Pallas kernels of pmg_dolfinx_tpu/ops/pallas_transfer.py:
//   transfer_x   <- _kernel_tx    t[a, y, z] = sum_x Mx[a, x] x3[x, y, z]
//   transfer_yz  <- _kernel_tyz   out[a]     = My @ t[a] @ MzT
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
// 2. transfer_yz: a block owns one a-slab and kTB consecutive output rows
//    b. It stages the rows of t[a] those b need (the union of their y
//    ranges, in chunks of at most yc rows) in shared memory, contracts y
//    into u[b][z] (kept in shared memory), then z: out[a, b, c] = sum over
//    c's range of u[b][z] MzT[z, c]. Threads run along z (stage 1) and c
//    (stage 2), so the staging reads, the MzT reads and the output writes
//    coalesce.
// The ranges come from the matrices themselves (ops/transfer.py:
// nonzero_ranges), so the kernels compute the dense product for any
// matrices; only the order of addition differs (y ascending, then z
// ascending, in true f32 FMA: precision="highest").
//
// Every C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (cudaErrorInvalidValue for a z-extent the
// shared memory cannot hold) so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTB = 16;                 // output rows b per transfer_yz block
constexpr int kYC = 64;                 // staged t rows per chunk, at most
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

__global__ void __launch_bounds__(kThreads)
transfer_yz(const float* __restrict__ t, const float* __restrict__ My,
            const int* __restrict__ ry, const float* __restrict__ MzT,
            const int* __restrict__ rz, float* __restrict__ out, int NY,
            int NZ, int B, int C, int yc) {
  extern __shared__ float smem[];
  float* su = smem;               // [kTB][NZ]  u[b][z] = sum_y My[b, y] t[a, y, z]
  float* st = smem + kTB * NZ;    // [yc][NZ]   staged rows of t[a]
  const int a = blockIdx.y, b0 = blockIdx.x * kTB;
  const int nb = min(kTB, B - b0);
  const float* ta = t + (int64_t)a * NY * NZ;

  // The t rows this tile needs: the union of its rows' y ranges.
  int ylo = NY, yhi = 0;
  for (int b = b0; b < b0 + nb; ++b) {
    if (ry[b] < ry[B + b]) {
      ylo = min(ylo, ry[b]);
      yhi = max(yhi, ry[B + b]);
    }
  }
  for (int i = threadIdx.x; i < nb * NZ; i += kThreads) su[i] = 0.f;
  for (int y0 = ylo; y0 < yhi; y0 += yc) {
    const int ny = min(yc, yhi - y0);
    __syncthreads();              // the previous chunk is consumed
    for (int i = threadIdx.x; i < ny * NZ; i += kThreads)
      st[i] = ta[(int64_t)y0 * NZ + i];
    __syncthreads();
    for (int i = threadIdx.x; i < nb * NZ; i += kThreads) {
      const int b = i / NZ, z = i - b * NZ;
      const int lo = max(ry[b0 + b], y0), hi = min(ry[B + b0 + b], y0 + ny);
      const float* row = My + (int64_t)(b0 + b) * NY;
      float acc = su[i];
      for (int y = lo; y < hi; ++y)
        acc = fmaf(row[y], st[(y - y0) * NZ + z], acc);
      su[i] = acc;
    }
  }
  __syncthreads();
  float* oa = out + ((int64_t)a * B + b0) * C;
  for (int i = threadIdx.x; i < nb * C; i += kThreads) {
    const int b = i / C, c = i - b * C;
    const float* ub = su + b * NZ;
    float acc = 0.f;
    for (int z = rz[c]; z < rz[C + c]; ++z)
      acc = fmaf(ub[z], MzT[(int64_t)z * C + c], acc);
    oa[i] = acc;
  }
}

// Staged rows per chunk for a t-slab of (NY, NZ): the most (up to kYC)
// whose shared memory fits next to u; 0 when not even one row does.
int yz_chunk(int NY, int NZ) {
  int yc = NY < kYC ? NY : kYC;
  while (yc > 0 && (int64_t)(kTB + yc) * NZ * 4 > kMaxSmem) --yc;
  return yc;
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

int transfer_yz_smem(int NY, int NZ) { return yz_chunk(NY, NZ); }

// out (A, B, C) = My (B, NY) t[a] (NY, NZ) MzT (NZ, C) for every a; ry is
// (2, B), the nonzero range of each row of My, rz (2, C) that of each
// column of MzT.
int transfer_yz_launch(const float* t, const float* My, const int* ry,
                       const float* MzT, const int* rz, float* out, int A,
                       int NY, int NZ, int B, int C, void* stream) {
  const int yc = yz_chunk(NY, NZ);
  if (yc <= 0) return (int)cudaErrorInvalidValue;
  const int smem = (kTB + yc) * NZ * (int)sizeof(float);
  static int opted_in = 48 * 1024;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        transfer_yz, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = smem;
  }
  const dim3 grid((unsigned)((B + kTB - 1) / kTB), (unsigned)A);
  transfer_yz<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      t, My, ry, MzT, rz, out, NY, NZ, B, C, yc);
  return (int)cudaGetLastError();
}

}  // extern "C"
