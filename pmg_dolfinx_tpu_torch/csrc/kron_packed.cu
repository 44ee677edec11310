// Hand-written Hopper (sm_90a) kernels for the small-lattice (serving)
// Kronecker apply and FDM direct solve, one launch sequence per batch.
//
// Replaces the Pallas kernels of pmg_dolfinx_tpu/ops/pallas_kron_packed.py:
//   packed_apply <- _packed_kernel            (:64,  PackedKronBatch)
//                   _packed_single_kernel     (:471, PackedKronSingle, B = 1)
//   packed_fdm   <- _packed_fdm_kernel        (:273, PackedFDMBatch)
//                   _packed_fdm_single_kernel (:797, PackedFDMSingle, B = 1)
//
// What is computed, per right-hand side b of a (B, NX, NY, NZ) batch
// (ops/kron_packed.py: plain_packed_apply / plain_packed_fdm):
//   apply:  w = bc ? 0 : x s3,   s3 = sxy[x, y] sz[z]
//           y = bc ? x : s3 (Ktx.w +x Kty.w +y Ktz.w +z sigma w)
//   fdm:    u = Vx Vy Vz (dinv * Vzt Vyt Vxt b),   y = bc ? b : u
// where "M.w +a" contracts axis a with the n x n matrix M, and the six V
// matrices are the boundary-embedded per-axis eigenvectors (dense).
//
// The TPU kernels pack B right-hand sides (or one lattice's x-slabs) into
// its 128 lanes, hold the whole packed batch in VMEM and run every
// contraction as one MXU dot. None of that layout carries over: the card
// has no lane tile to fill and 227 KB of shared memory per block (one
// 61^3 f32 lattice is 0.91 MB). What bounds it here: at the serving size
// (61^3, p=6) one right-hand side is 0.91 MB, so a batch of up to ~27
// stays in the 50 MB L2 between passes; the apply sums over the band of
// the symmetrized stiffness (half-width P, 3(2P+1) FMAs per output), the
// FDM does six dense transforms (6n FMAs per point, 366 at n = 61). At
// B = 1 a pass moves ~2 MB, under a microsecond at HBM speed, so launch
// latency sets the time there.
//
// Design: every contraction is one "line pass". A line is the n values of
// one (b, other-axes) index along the contracted axis.
//  - axis_pass (x or y): a block owns one (b, o) pair -- o the other of
//    x / y -- and all NZ <= 64 z-lines under it. It stages the block's
//    n x NZ tile (z fastest, coalesced) and M^T (k-major, zero padded) in
//    shared memory; thread (z, g) sums outputs a0..a0+7 of its z-line for
//    a0 = 8g, 8(g+4), ...: per k one scalar and two float4 reads of shared
//    memory feed 8 FMAs, the float4s broadcast across the warp.
//  - z_pass: a block owns 32 consecutive z-lines (a contiguous chunk of
//    memory, loaded coalesced into a tile with an odd row stride, so the
//    32 lines of a warp hit 32 banks); thread (line, g) sums outputs
//    8g..8g+7 of its line. The FDM z pass does z-forward, the dinv scale
//    and z-backward in shared memory, as the TPU kernel does in its lane
//    group loop; the apply z pass carries the epilogue.
//  - apply = x pass (t = Ktx.w), y pass (t += Kty.w), z pass (y = ...):
//    three launches. The band bounds the k loops (entries outside it are
//    zero, checked in float64 at setup).
//  - fdm = x fwd, y fwd, z fwd * dinv bwd, y bwd, x bwd + the bc
//    epilogue: five launches.
// Sums run in true f32 FMA on the CUDA cores (the JAX package's
// precision="highest" contract), in ascending k; only the order of
// addition differs from a dense product.
//
// Every C entry point launches on the caller's stream, allocates nothing
// (the wrapper passes the scratch lattices) and returns cudaGetLastError()
// after each launch, or cudaErrorInvalidValue for extents the kernels are
// not compiled for, so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 128;          // largest x / y extent
constexpr int kMaxNZ = 64;          // largest z extent (the classes' NZ <= 64)
constexpr int kZT = 64;             // threads along z in axis_pass
constexpr int kAG = 4;              // output groups per line in axis_pass
constexpr int kR = 8;               // outputs one thread sums at once
constexpr int kLines = 32;          // z-lines per block in z_pass
constexpr int kCG = kMaxNZ / kR;    // output groups per z-line in z_pass
constexpr int kLS = kMaxNZ + 1;     // odd row stride of the z-line tiles
constexpr int kMaxBatch = 65535;    // gridDim.y of axis_pass

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// sMT[k * np + a] = M[a * n + k] for a < n, 0 for n <= a < np.
__device__ void stage_transposed(float* sMT, const float* __restrict__ M,
                                 int n, int np) {
  const int nt = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int t = tid; t < n * np; t += nt) {
    const int k = t / np, a = t % np;
    sMT[t] = a < n ? M[a * n + k] : 0.f;
  }
}

// s[r] = sum_{k0 <= k < k1} M[a0 + r, k] * line[k * ls], ascending k.
__device__ __forceinline__ void line_sum(float (&s)[kR], const float* sMT,
                                         int np, int a0, const float* line,
                                         int ls, int k0, int k1) {
#pragma unroll
  for (int r = 0; r < kR; ++r) s[r] = 0.f;
  for (int k = k0; k < k1; ++k) {
    const float v = line[k * ls];
    const float4 m0 = *reinterpret_cast<const float4*>(sMT + k * np + a0);
    const float4 m1 = *reinterpret_cast<const float4*>(sMT + k * np + a0 + 4);
    s[0] = fmaf(m0.x, v, s[0]);
    s[1] = fmaf(m0.y, v, s[1]);
    s[2] = fmaf(m0.z, v, s[2]);
    s[3] = fmaf(m0.w, v, s[3]);
    s[4] = fmaf(m1.x, v, s[4]);
    s[5] = fmaf(m1.y, v, s[5]);
    s[6] = fmaf(m1.z, v, s[6]);
    s[7] = fmaf(m1.w, v, s[7]);
  }
}

// One x (axis 0) or y (axis 1) contraction of every line of the batch:
// out[a] = sum_k M[a, k] w[k]. APPLY: w = bc ? 0 : in * s3, else w = in.
// ACC: out = acc + sum (acc may alias out). EPI: out = bc ? src : sum.
template <bool APPLY, bool ACC, bool EPI>
__global__ void __launch_bounds__(kZT * kAG)
axis_pass(const float* __restrict__ in, const float* __restrict__ M,
          const unsigned char* __restrict__ bc, const float* __restrict__ sxy,
          const float* __restrict__ sz, const float* acc,
          const float* __restrict__ src, float* out, int NX, int NY, int NZ,
          int axis, int band) {
  extern __shared__ __align__(16) float smem[];
  const int n = axis == 0 ? NX : NY;
  const int np = round_up(n, kR);
  float* sMT = smem;                  // [n][np]  M^T
  float* sw = smem + n * np;          // [n][kZT] the block's lines
  const int tz = threadIdx.x, ag = threadIdx.y;
  const int o = blockIdx.x;           // the other of x / y
  const int64_t base = (int64_t)blockIdx.y * NX * NY * NZ;
  const int64_t sk = axis == 0 ? (int64_t)NY * NZ : NZ;
  const int64_t so = axis == 0 ? (int64_t)NZ : (int64_t)NY * NZ;

  stage_transposed(sMT, M, n, np);
  for (int k = ag; k < n; k += kAG) {
    float v = 0.f;
    if (tz < NZ) {
      const int64_t cell = k * sk + o * so + tz;
      v = in[base + cell];
      if (APPLY) {
        const int x = axis == 0 ? k : o, y = axis == 0 ? o : k;
        v = bc[cell] ? 0.f : v * (sxy[x * NY + y] * sz[tz]);
      }
    }
    sw[k * kZT + tz] = v;
  }
  __syncthreads();
  if (tz >= NZ) return;
  for (int a0 = ag * kR; a0 < n; a0 += kAG * kR) {
    float s[kR];
    line_sum(s, sMT, np, a0, sw + tz, kZT, max(0, a0 - band),
             min(n, a0 + kR + band));
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (a0 + r >= n) break;
      const int64_t cell = (a0 + r) * sk + o * so + tz;
      float y = s[r];
      if (ACC) y = acc[base + cell] + y;
      if (EPI) y = bc[cell] ? src[base + cell] : y;
      out[base + cell] = y;
    }
  }
}

// The z contraction of every line (NZ contiguous floats) of the batch.
// APPLY: w = bc ? 0 : in * s3; out = bc ? in : s3 (acc + Ktz.w + sigma w).
// FDM:   out = M2 . (dinv * (M . in)), M = Vzt, M2 = Vz.
template <bool APPLY>
__global__ void __launch_bounds__(kLines * kCG)
z_pass(const float* __restrict__ in, const float* __restrict__ M,
       const float* __restrict__ M2, const unsigned char* __restrict__ bc,
       const float* __restrict__ sxy, const float* __restrict__ sz,
       const float* __restrict__ dinv, const float* __restrict__ acc,
       float* __restrict__ out, int64_t lines, int NXY, int NZ, int band,
       float sigma) {
  extern __shared__ __align__(16) float smem[];
  const int np = round_up(NZ, kR);
  float* sMT = smem;                              // [NZ][np] M^T
  float* sMT2 = sMT + NZ * np;                    // [NZ][np] M2^T (FDM)
  float* sa = sMT2 + (APPLY ? 0 : NZ * np);       // [kLines][kLS]
  float* sb = sa + kLines * kLS;                  // [kLines][kLS]
  const int tl = threadIdx.x, cg = threadIdx.y;
  const int tid = cg * kLines + tl, nt = kLines * kCG;
  const int64_t l0 = (int64_t)blockIdx.x * kLines;
  const int nl = (int)min((int64_t)kLines, lines - l0);
  const int64_t lattice = (int64_t)NXY * NZ;

  stage_transposed(sMT, M, NZ, np);
  if (!APPLY) stage_transposed(sMT2, M2, NZ, np);
  for (int t = tid; t < nl * NZ; t += nt) {
    const int li = t / NZ, k = t % NZ;
    const int64_t g = (l0 + li) * NZ + k;
    float v = in[g];
    if (APPLY) {
      const int64_t cell = g % lattice;
      v = bc[cell] ? 0.f : v * (sxy[cell / NZ] * sz[k]);
    }
    sa[li * kLS + k] = v;
  }
  __syncthreads();
  const int c0 = cg * kR;
  float s[kR];
  if (tl < nl && c0 < NZ) {
    line_sum(s, sMT, np, c0, sa + tl * kLS, 1, max(0, c0 - band),
             min(NZ, c0 + kR + band));
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (c0 + r < NZ) sb[tl * kLS + c0 + r] = s[r];
  }
  __syncthreads();
  if (APPLY) {
    for (int t = tid; t < nl * NZ; t += nt) {
      const int li = t / NZ, k = t % NZ;
      const int64_t g = (l0 + li) * NZ + k;
      const int64_t cell = g % lattice;
      float a = acc[g] + sb[li * kLS + k];
      if (sigma != 0.f) a = a + sigma * sa[li * kLS + k];
      out[g] = bc[cell] ? in[g] : a * (sxy[cell / NZ] * sz[k]);
    }
    return;
  }
  for (int t = tid; t < nl * NZ; t += nt) {
    const int li = t / NZ, k = t % NZ;
    sb[li * kLS + k] *= dinv[((l0 + li) * NZ + k) % lattice];
  }
  __syncthreads();
  if (tl < nl && c0 < NZ) {
    line_sum(s, sMT2, np, c0, sb + tl * kLS, 1, 0, NZ);
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (c0 + r < NZ) sa[tl * kLS + c0 + r] = s[r];
  }
  __syncthreads();
  for (int t = tid; t < nl * NZ; t += nt) {
    const int li = t / NZ, k = t % NZ;
    out[(l0 + li) * NZ + k] = sa[li * kLS + k];
  }
}

constexpr size_t kAxisSmemMax = sizeof(float) * (kMaxN * kMaxN + kMaxN * kZT);
constexpr size_t kZSmemMax =
    sizeof(float) * (2 * kMaxNZ * kMaxNZ + 2 * kLines * kLS);

// Raises a kernel's dynamic shared memory limit once (above 48 KB a launch
// is refused without it).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = e == cudaSuccess;
  return e;
}

template <bool APPLY, bool ACC, bool EPI>
cudaError_t launch_axis(const float* in, const float* M,
                        const unsigned char* bc, const float* sxy,
                        const float* sz, const float* acc, const float* src,
                        float* out, int B, int NX, int NY, int NZ, int axis,
                        int band, cudaStream_t stream) {
  static bool raised = false;
  cudaError_t e = allow_smem(axis_pass<APPLY, ACC, EPI>, kAxisSmemMax, raised);
  if (e != cudaSuccess) return e;
  const int n = axis == 0 ? NX : NY;
  const size_t smem = sizeof(float) * (n * round_up(n, kR) + n * kZT);
  const dim3 grid((unsigned)(axis == 0 ? NY : NX), (unsigned)B);
  axis_pass<APPLY, ACC, EPI><<<grid, dim3(kZT, kAG), smem, stream>>>(
      in, M, bc, sxy, sz, acc, src, out, NX, NY, NZ, axis, band);
  return cudaGetLastError();
}

template <bool APPLY>
cudaError_t launch_z(const float* in, const float* M, const float* M2,
                     const unsigned char* bc, const float* sxy,
                     const float* sz, const float* dinv, const float* acc,
                     float* out, int B, int NX, int NY, int NZ, int band,
                     float sigma, cudaStream_t stream) {
  static bool raised = false;
  cudaError_t e = allow_smem(z_pass<APPLY>, kZSmemMax, raised);
  if (e != cudaSuccess) return e;
  const int np = round_up(NZ, kR);
  const size_t smem =
      sizeof(float) * ((APPLY ? 1 : 2) * NZ * np + 2 * kLines * kLS);
  const int64_t lines = (int64_t)B * NX * NY;
  const unsigned blocks = (unsigned)((lines + kLines - 1) / kLines);
  z_pass<APPLY><<<blocks, dim3(kLines, kCG), smem, stream>>>(
      in, M, M2, bc, sxy, sz, dinv, acc, out, lines, NX * NY, NZ, band,
      sigma);
  return cudaGetLastError();
}

bool extents_ok(int B, int NX, int NY, int NZ) {
  return B >= 1 && B <= kMaxBatch && NX >= 1 && NX <= kMaxN && NY >= 1 &&
         NY <= kMaxN && NZ >= 1 && NZ <= kMaxNZ;
}

}  // namespace

extern "C" {

int packed_max_n() { return kMaxN; }
int packed_max_nz() { return kMaxNZ; }
int packed_max_batch() { return kMaxBatch; }

// y = A x per right-hand side; t is a scratch lattice batch like x.
int packed_apply_launch(const float* x, const unsigned char* bc,
                        const float* sxy, const float* sz, const float* Ktx,
                        const float* Kty, const float* Ktz, float* t,
                        float* out, int B, int NX, int NY, int NZ, int band,
                        float sigma, void* stream) {
  if (!extents_ok(B, NX, NY, NZ) || band < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = launch_axis<true, false, false>(
      x, Ktx, bc, sxy, sz, nullptr, nullptr, t, B, NX, NY, NZ, 0, band, s);
  if (e != cudaSuccess) return (int)e;
  e = launch_axis<true, true, false>(x, Kty, bc, sxy, sz, t, nullptr, t, B,
                                     NX, NY, NZ, 1, band, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_z<true>(x, Ktz, nullptr, bc, sxy, sz, nullptr, t, out,
                             B, NX, NY, NZ, band, sigma, s);
}

// y = bc ? b : A^{-1} b per right-hand side; t1, t2 are scratch batches.
int packed_fdm_launch(const float* b, const unsigned char* bc,
                      const float* Vxt, const float* Vx, const float* Vyt,
                      const float* Vy, const float* Vzt, const float* Vz,
                      const float* dinv, float* t1, float* t2, float* out,
                      int B, int NX, int NY, int NZ, void* stream) {
  if (!extents_ok(B, NX, NY, NZ)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int dense = kMaxN;  // a band wider than any extent: dense sums
  cudaError_t e = launch_axis<false, false, false>(
      b, Vxt, bc, nullptr, nullptr, nullptr, nullptr, t1, B, NX, NY, NZ, 0,
      dense, s);
  if (e != cudaSuccess) return (int)e;
  e = launch_axis<false, false, false>(t1, Vyt, bc, nullptr, nullptr, nullptr,
                                       nullptr, t2, B, NX, NY, NZ, 1, dense,
                                       s);
  if (e != cudaSuccess) return (int)e;
  e = launch_z<false>(t2, Vzt, Vz, bc, nullptr, nullptr, dinv, nullptr, t1, B,
                      NX, NY, NZ, dense, 0.f, s);
  if (e != cudaSuccess) return (int)e;
  e = launch_axis<false, false, false>(t1, Vy, bc, nullptr, nullptr, nullptr,
                                       nullptr, t2, B, NX, NY, NZ, 1, dense,
                                       s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_axis<false, false, true>(t2, Vx, bc, nullptr, nullptr,
                                              nullptr, b, out, B, NX, NY, NZ,
                                              0, dense, s);
}

}  // extern "C"
