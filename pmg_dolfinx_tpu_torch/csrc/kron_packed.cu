// Hand-written Hopper (sm_90a) kernels for the small-lattice (serving)
// Kronecker apply and FDM direct solve of a whole batch.
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
// has no lane tile to fill, 227 KB of shared memory per block (one 61^3
// f32 lattice is 0.91 MB), and its float32 FMAs run on the CUDA cores
// (the JAX package's precision="highest" contract; no TF32).
//
// What bounds them here, at the serving size (61^3, p=6):
//  - the apply sums 3 (2P+1) = 39 FMAs per output over the band of the
//    symmetrized stiffness: below the f32 ridge (~20 FLOP per byte), so
//    bytes bound it once the batch leaves L2 (B >= ~27), launch latency
//    at B = 1 (one pass moves ~2 MB, under a microsecond of HBM time);
//  - the FDM does six dense transforms, 12 n FMAs per point (733 FLOP at
//    n = 61), ~92 FLOP per byte: float32 operations bound it, so its
//    sums must issue many FMAs per shared-memory load.
//
// packed_apply: one launch, no scratch (packed_apply_march). A block of
// 512 threads owns an x-chunk and a tile of YT y-rows over all z (ZL = 32
// or 64 z values, a pair per thread: YT = 16 at ZL = 64) and marches
// along x. A plane's rows of the tile and its y halo are one contiguous
// range of x: one thread moves it, kAhead planes ahead, with a bulk copy
// (the Tensor Memory Accelerator's 1D form) that completes on the raw
// slot's mbarrier, the marker likewise (padded to 16-byte rows); no
// registers are held for the prefetch. At its step the block converts the
// plane to w in a ring of BAND + 1 w slots (a zero z halo), each thread
// keeping its pair's w, raw x and bc in register rings of 2 BAND + 1
// planes for the x term and the epilogue, and sums plane xn - BAND: the y
// and z terms from its w slot, every shared access a float2 per pair.
// One barrier per plane. The host picks the chunk (ops/kron_packed.py:
// apply_plan) from the batch and the SM count: 2 planes at B = 1 so the
// grid covers the card, 16 at B = 8, one whole-x chunk at B = 64 so the x
// halo is read once. Bands above kMaxBandMarch (degree > 8, none on the
// serving path) run packed_apply_direct: one thread per output, its
// neighbours from L1/L2, the same sums in the same order. What holds the
// march back on the card (PERF.md): one 16-warp block per SM (128
// registers a thread) spends ~1 us a plane at 61^3, several times the
// plane's shared-memory and issue time: B = 8 runs at ~13% of its bound.

// packed_fdm: three launches and one scratch batch t of padded layout
// (B, NX, NY, NZp), NZp = NZ rounded up to 4, every transform a
// register-tiled f32 product: each thread sums a 4 x 4 output tile, two
// float4 shared-memory loads feeding 16 FMAs.
//  1. fdm_x_pass<false>: t = Vxt .x b per right-hand side, an [NX x NX] .
//     [NX x NY NZp] product; b's columns gathered with 4-byte cp.async
//     into 32- or 64-column tiles (zero-filled z padding), double-buffered.
//  2. fdm_slab_pass: a block holds one x-slab of one right-hand side
//     (NY x NZp floats) in shared memory and runs y-forward, z-forward,
//     the dinv scale, z-backward and y-backward on it: four of the six
//     transforms for one read and one write of the slab, in place in t
//     (each slab is read and written by one block, or pair, only). The y
//     products take the slab as their k-major operand; the z products
//     read it row-major, float4 along k, so no transform transposes the
//     slab. The next slab is prefetched with cp.async while the block
//     works (when three slab buffers fit: NY <= 64 at NZ = 64). When the
//     batch has fewer slabs than half the card's blocks (B = 1, 2 at
//     61^3), fdm_slab_pair runs each slab on a cluster of two blocks
//     that split the rows and exchange the z-backward halves through
//     distributed shared memory.
//  3. fdm_x_pass<true>: out = bc ? b : Vx .x t; the tile's b values and
//     marker bytes arrive by cp.async during the product, the output tile
//     is staged in shared memory and written coalesced.
// The matrices come laid out once at setup (ops/kron_packed.py:fdm_mats):
// transposed to k-major and padded to whole float4s, so every block
// stages them with coalesced 16-byte cp.async, once: the grids are
// persistent (occupancy x SMs blocks, each walking many tiles or slabs),
// and each x pass takes the tile width whose waves cost least (fdm_plan).

// Order of the sums. Every FDM sum runs over k ascending from 0 with
// fmaf, the parent kernels' order (the z products add zero products over
// the padding k >= NZ, which leaves a finite sum unchanged): the same
// bits. The apply sums each axis's band in ascending k and adds the terms
// as ((tx + ty) + tz) + sigma w, as the three passes it replaces did.
//
// Every C entry point launches on the caller's stream, allocates nothing
// (the wrapper passes the scratch) and returns cudaGetLastError() after
// each launch, or cudaErrorInvalidValue for extents the kernels are not
// compiled for, so the Python wrapper can raise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

namespace {

constexpr int kMaxN = 128;          // largest x / y extent
constexpr int kMaxNZ = 64;          // largest z extent (the classes' NZ <= 64)
constexpr int kMaxBatch = 65535;    // gridDim.z of the apply march

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }
__host__ __device__ constexpr int band_pad(int band) {
  return round4(2 * band + 1);
}

// f(std::integral_constant<int, I>) for I = B .. E - 1 in order: a loop
// whose index must be a compile-time constant (register rings), which
// `#pragma unroll` does not guarantee for a large body.
template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    static_for<B + 1, E>(f);
  }
}

// --- asynchronous copies (sm_80+) --------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
// Four bytes, or four zero bytes when !valid (src is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// Hopper's bulk copy (TMA, one thread) into shared memory, completing on
// an mbarrier that expects its bytes; a consumer waits on the barrier's
// phase parity. Both ends 16-byte aligned, a multiple of 16 bytes.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_addr(bar)));
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "fence.proxy.async.shared::cta;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// Copy nf floats (a multiple of 4; both ends 16-byte aligned).
__device__ __forceinline__ void stage16(float* s, const float* g, int nf,
                                        int tid, int nt) {
  for (int i = 4 * tid; i < nf; i += 4 * nt) cp_async16(s + i, g + i);
}

// --- register-tiled products ---------------------------------------------------

// acc[4 r + c] += sum_{k < K} L[k ls + i0 + r] R[k rs + j0 + c]: both
// operands k-major, k ascending.
__device__ __forceinline__ void mm_outer(float (&acc)[16], const float* L,
                                         int ls, int i0, const float* R,
                                         int rs, int j0, int K) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(L + k * ls + i0);
    const float4 b = *reinterpret_cast<const float4*>(R + k * rs + j0);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[4 * r + c] = fmaf(av[r], bv[c], acc[4 * r + c]);
  }
}

// acc[4 r + c] += sum_{k < K} A[(i0 + r) as + k] R[k rs + j0 + c]: A
// row-major, read as float4 along k; K a multiple of 4, k ascending.
__device__ __forceinline__ void mm_rows(float (&acc)[16], const float* A,
                                        int as, int i0, const float* R,
                                        int rs, int j0, int K) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float a[4][4], b[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 v =
          *reinterpret_cast<const float4*>(A + (i0 + r) * as + k);
      a[r][0] = v.x; a[r][1] = v.y; a[r][2] = v.z; a[r][3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(R + (k + q) * rs + j0);
      b[q][0] = v.x; b[q][1] = v.y; b[q][2] = v.z; b[q][3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[4 * r + c] = fmaf(a[r][q], b[q][c], acc[4 * r + c]);
  }
}

__device__ __forceinline__ void zero16(float (&acc)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// --- FDM: the x passes ---------------------------------------------------------

constexpr int kXThreads = 256;
constexpr int kTilesPerThread = 2;  // (128 / 4) x (64 / 4) tiles / 256 threads

// Shared memory of an x pass with CT-column tiles: L, two R tiles and, for
// the backward pass, the tile's b values and bc bytes.
__host__ __device__ constexpr size_t x_pass_smem(int NX, int CT, bool bwd) {
  return sizeof(float) * ((size_t)NX * round4(NX) + 2 * (size_t)round4(NX) * CT +
                          (bwd ? (size_t)NX * CT : 0)) +
         (bwd ? (size_t)NX * CT : 0);
}

// BWD = false: t[b, a, :] = sum_x Vxt[a, x] b[b, x, :] (t padded along z);
// BWD = true: out[b, x, :] = bc ? src : sum_a Vx[x, a] t[b, a, :].
// L[k][i] (k < NX, i < NXp) is the k-major matrix (Vxt^T, resp. Vx^T);
// bcp the marker padded like t (NX, NY, NZp). A block walks tiles of CT
// padded columns of one right-hand side, every thread summing TPT 4 x 4
// output tiles; thread t loads and stores column t % CT of a tile.
template <bool BWD, int TPT, int CT>
__global__ void __launch_bounds__(kXThreads, TPT == 1 ? 4 : 2)
fdm_x_pass(const float* __restrict__ in, const float* __restrict__ L,
           const float* __restrict__ src,
           const unsigned char* __restrict__ bcp, float* __restrict__ out,
           int B, int NX, int NY, int NZ) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RS = kXThreads / CT;       // rows one pass of the block covers
  const int NXp = round4(NX), NZp = round4(NZ);
  const int ncol = NY * NZp;               // padded columns per right-hand side
  const int ctiles = (ncol + CT - 1) / CT;
  const int64_t tiles = (int64_t)B * ctiles;
  const int64_t N = (int64_t)NX * NY * NZ;
  float* sL = smem;                        // [NX][NXp]
  float* sR[2] = {sL + NX * NXp, sL + NX * NXp + NXp * CT};  // [NXp][CT]
  float* sS = sR[1] + NXp * CT;            // BWD: [NX][CT] b at the tile
  unsigned char* sBc = reinterpret_cast<unsigned char*>(sS + NX * CT);
  const int tid = threadIdx.x, c = tid % CT, r0 = tid / CT;
  const int ntile = (NXp / 4) * (CT / 4);

  // The (y, z) of this thread's column of tile t, and whether it is real.
  auto column = [&](int64_t t, int64_t& b, int& y, int& z) {
    b = t / ctiles;
    const int j = (int)(t - b * ctiles) * CT + c;
    y = j / NZp;
    z = j - y * NZp;
    return y < NY && z < NZ;
  };
  auto load = [&](int64_t t, float* R) {
    int64_t b;
    int y, z;
    if (BWD) {
      b = t / ctiles;
      const int j0 = (int)(t - b * ctiles) * CT;
      for (int e = tid; e < NX * (CT / 4); e += kXThreads) {
        const int k = e / (CT / 4), j = j0 + 4 * (e % (CT / 4));
        if (j < ncol)
          cp_async16(R + k * CT + j - j0, in + (b * NX + k) * ncol + j);
      }
    } else {
      const bool ok = column(t, b, y, z);
      const float* g = in + (b * NX * NY + y) * NZ + z;
      for (int k = r0; k < NX; k += RS)
        cp_async4(R + k * CT + c, ok ? g + (int64_t)k * NY * NZ : in, ok);
    }
  };
  // BWD: the tile's b values and bc bytes, for the epilogue.
  auto load_epilogue = [&](int64_t t) {
    int64_t b;
    int y, z;
    const bool ok = column(t, b, y, z);
    const float* g = src + (b * NX * NY + y) * NZ + z;
    for (int k = r0; k < NX; k += RS)
      cp_async4(sS + k * CT + c, ok ? g + (int64_t)k * NY * NZ : src, ok);
    const int j0 = (int)(t - b * ctiles) * CT;
    for (int e = tid; e < NX * (CT / 4); e += kXThreads) {
      const int k = e / (CT / 4), j = j0 + 4 * (e % (CT / 4));
      cp_async4(reinterpret_cast<float*>(sBc + k * CT + j - j0),
                reinterpret_cast<const float*>(bcp + (int64_t)k * ncol + j),
                j < ncol);
    }
  };

  stage16(sL, L, NX * NXp, tid, kXThreads);
  int64_t t = blockIdx.x;
  if (t < tiles) load(t, sR[0]);
  cp_async_commit();
  for (int buf = 0; t < tiles; t += gridDim.x, buf ^= 1) {
    float* R = sR[buf];
    if (BWD) {
      load_epilogue(t);
      cp_async_commit();
    }
    if (t + gridDim.x < tiles) load(t + gridDim.x, sR[buf ^ 1]);
    cp_async_commit();
    if (BWD)
      cp_async_wait<2>();                  // L and tile t have landed
    else
      cp_async_wait<1>();
    __syncthreads();
    const int64_t b = t / ctiles;
    const int j0 = (int)(t - b * ctiles) * CT;
    float acc[TPT][16];
#pragma unroll
    for (int q = 0; q < TPT; ++q) {
      const int u = tid + q * kXThreads;
      zero16(acc[q]);
      if (u < ntile)
        mm_outer(acc[q], sL, NXp, 4 * (u / (CT / 4)), R, CT,
                 4 * (u % (CT / 4)), NX);
    }
    if (!BWD) {
#pragma unroll
      for (int q = 0; q < TPT; ++q) {
        const int u = tid + q * kXThreads;
        const int i0 = 4 * (u / (CT / 4)), j = j0 + 4 * (u % (CT / 4));
        if (u >= ntile || j >= ncol) continue;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (i0 + r < NX)
            store4(out + (b * NX + i0 + r) * ncol + j, acc[q] + 4 * r);
      }
    } else {
      cp_async_wait<1>();                  // the epilogue's b and bc
      __syncthreads();                     // every read of R is done
#pragma unroll
      for (int q = 0; q < TPT; ++q) {
        const int u = tid + q * kXThreads;
        if (u >= ntile) continue;
        const int i0 = 4 * (u / (CT / 4)), c0 = 4 * (u % (CT / 4));
#pragma unroll
        for (int r = 0; r < 4; ++r) store4(R + (i0 + r) * CT + c0, acc[q] + 4 * r);
      }
      __syncthreads();
      int64_t bb;
      int y, z;
      if (column(t, bb, y, z)) {
        float* o = out + bb * N + (int64_t)y * NZ + z;
        for (int k = r0; k < NX; k += RS)
          o[(int64_t)k * NY * NZ] = sBc[k * CT + c] ? sS[k * CT + c] : R[k * CT + c];
      }
    }
    __syncthreads();                       // R is refilled two tiles on
  }
}

// --- FDM: the slab pass ----------------------------------------------------------

constexpr int kSThreads = 256;

// Shared memory of the slab pass with nbuf slab buffers: the four
// k-major matrices and the buffers, each [NYp][NZp].

__host__ __device__ constexpr size_t slab_smem(int NY, int NZ, int nbuf) {
  return sizeof(float) * (2 * (size_t)NY * round4(NY) +
                          2 * (size_t)round4(NZ) * round4(NZ) +
                          (size_t)nbuf * round4(NY) * round4(NZ));
}

// t[b, a] (NY x NZp) <- Vy Vz (dinv[a] * Vzt Vyt t[b, a]) for every slab.
// Lyf[y][c] = Vyt[c, y], Lyb[c][y] = Vy[y, c] ([NY][NYp]); Rzf[z][e] =
// Vzt[e, z], Rzb[e][z] = Vz[z, e] ([NZp][NZp], zero rows past NZ); dinvp
// (NX, NY, NZp). NBUF = 3 prefetches the next slab while one is worked.
// PAIR: a cluster of two blocks shares each slab (for batches with fewer
// slabs than the card has blocks): each block takes half the rows of the
// y-forward and z products and of the y-backward outputs, and copies the
// other half of the z-backward result from its partner's shared memory
// (distributed shared memory) before the y-backward product, so both sum
// every k in the same order as one block would.
template <int NBUF, bool PAIR>
__device__ __forceinline__ void slab_body(
    float* t, const float* __restrict__ Lyf, const float* __restrict__ Lyb,
    const float* __restrict__ Rzf, const float* __restrict__ Rzb,
    const float* __restrict__ dinvp, int B, int NX, int NY, int NZ) {
  extern __shared__ __align__(16) float smem[];
  const int NYp = round4(NY), NZp = round4(NZ);
  const int slab = NY * NZp, buf = NYp * NZp;
  float* sLyf = smem;                      // [NY][NYp]
  float* sLyb = sLyf + NY * NYp;
  float* sRzf = sLyb + NY * NYp;           // [NZp][NZp]
  float* sRzb = sRzf + NZp * NZp;
  float* sA[2] = {sRzb + NZp * NZp, sRzb + NZp * NZp + (NBUF == 3 ? buf : 0)};
  float* sB = sRzb + NZp * NZp + (NBUF - 1) * buf;
  const int tid = threadIdx.x;
  const int64_t slabs = (int64_t)B * NX;
  // This block's rows [r0, r1) of the products' outputs.
  const int half = round4((NYp + 1) / 2);
  const unsigned rank = PAIR ? cooperative_groups::this_cluster().block_rank()
                             : 0u;
  const int r0 = rank ? half : 0, r1 = PAIR ? (rank ? NYp : half) : NYp;
  const int ntile = ((r1 - r0) / 4) * (NZp / 4);
  const int64_t first = PAIR ? blockIdx.x / 2 : blockIdx.x;
  const int64_t stride = PAIR ? gridDim.x / 2 : gridDim.x;

  stage16(sLyf, Lyf, NY * NYp, tid, kSThreads);
  stage16(sLyb, Lyb, NY * NYp, tid, kSThreads);
  stage16(sRzf, Rzf, NZp * NZp, tid, kSThreads);
  stage16(sRzb, Rzb, NZp * NZp, tid, kSThreads);
  int64_t s = first;
  if (s < slabs) stage16(sA[0], t + s * slab, slab, tid, kSThreads);
  cp_async_commit();
  for (int cur = 0; s < slabs; s += stride) {
    float* A = sA[cur];
    cp_async_wait<0>();
    __syncthreads();
    const int64_t sn = s + stride;
    if (NBUF == 3 && sn < slabs) {
      stage16(sA[cur ^ 1], t + sn * slab, slab, tid, kSThreads);
      cp_async_commit();
    }
    const int a = (int)(s % NX);
    // y forward: sB[c][z] = sum_y Vyt[c, y] A[y][z].
#pragma unroll
    for (int q = 0; q < kTilesPerThread; ++q) {
      const int u = tid + q * kSThreads;
      if (u >= ntile) break;
      const int i0 = r0 + 4 * (u / (NZp / 4)), j0 = 4 * (u % (NZp / 4));
      float acc[16];
      zero16(acc);
      mm_outer(acc, sLyf, NYp, i0, A, NZp, j0, NY);
#pragma unroll
      for (int r = 0; r < 4; ++r) store4(sB + (i0 + r) * NZp + j0, acc + 4 * r);
    }
    __syncthreads();
    // z forward and the scale: A[c][e] = dinv[a, c, e] sum_z sB[c][z] Vzt[e, z].
#pragma unroll
    for (int q = 0; q < kTilesPerThread; ++q) {
      const int u = tid + q * kSThreads;
      if (u >= ntile) break;
      const int i0 = r0 + 4 * (u / (NZp / 4)), j0 = 4 * (u % (NZp / 4));
      float dv[16];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 v =
            i0 + r < NY ? *reinterpret_cast<const float4*>(
                              dinvp + ((int64_t)a * NY + i0 + r) * NZp + j0)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        dv[4 * r] = v.x; dv[4 * r + 1] = v.y; dv[4 * r + 2] = v.z;
        dv[4 * r + 3] = v.w;
      }
      float acc[16];
      zero16(acc);
      mm_rows(acc, sB, NZp, i0, sRzf, NZp, j0, NZp);
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] *= dv[e];
#pragma unroll
      for (int r = 0; r < 4; ++r) store4(A + (i0 + r) * NZp + j0, acc + 4 * r);
    }
    __syncthreads();
    // z backward: sB[c][z] = sum_e A[c][e] Vz[z, e].
#pragma unroll
    for (int q = 0; q < kTilesPerThread; ++q) {
      const int u = tid + q * kSThreads;
      if (u >= ntile) break;
      const int i0 = r0 + 4 * (u / (NZp / 4)), j0 = 4 * (u % (NZp / 4));
      float acc[16];
      zero16(acc);
      mm_rows(acc, A, NZp, i0, sRzb, NZp, j0, NZp);
#pragma unroll
      for (int r = 0; r < 4; ++r) store4(sB + (i0 + r) * NZp + j0, acc + 4 * r);
    }
    if (PAIR) {
      // The partner's rows of sB, after both have written theirs; the
      // second sync keeps them until both have copied.
      cooperative_groups::cluster_group cluster =
          cooperative_groups::this_cluster();
      cluster.sync();
      const int p0 = rank ? 0 : half, p1 = rank ? half : NYp;
      const float* other = cluster.map_shared_rank(sB, rank ^ 1u);
      for (int i = 4 * tid; i < (p1 - p0) * NZp; i += 4 * kSThreads)
        *reinterpret_cast<float4*>(sB + p0 * NZp + i) =
            *reinterpret_cast<const float4*>(other + p0 * NZp + i);
      cluster.sync();
    } else {
      __syncthreads();
    }
    // y backward, to t: t[b, a][y][z] = sum_c Vy[y, c] sB[c][z].
#pragma unroll
    for (int q = 0; q < kTilesPerThread; ++q) {
      const int u = tid + q * kSThreads;
      if (u >= ntile) break;
      const int i0 = r0 + 4 * (u / (NZp / 4)), j0 = 4 * (u % (NZp / 4));
      float acc[16];
      zero16(acc);
      mm_outer(acc, sLyb, NYp, i0, sB, NZp, j0, NY);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (i0 + r < NY) store4(t + s * slab + (i0 + r) * NZp + j0, acc + 4 * r);
    }
    if (NBUF == 3) {
      cur ^= 1;
    } else if (sn < slabs) {
      __syncthreads();                     // every read of A and sB is done
      stage16(sA[0], t + sn * slab, slab, tid, kSThreads);
      cp_async_commit();
    }
  }
}

template <int NBUF>
__global__ void __launch_bounds__(kSThreads, 2)
fdm_slab_pass(float* t, const float* __restrict__ Lyf,
              const float* __restrict__ Lyb, const float* __restrict__ Rzf,
              const float* __restrict__ Rzb, const float* __restrict__ dinvp,
              int B, int NX, int NY, int NZ) {
  slab_body<NBUF, false>(t, Lyf, Lyb, Rzf, Rzb, dinvp, B, NX, NY, NZ);
}

template <int NBUF>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kSThreads, 2)
fdm_slab_pair(float* t, const float* __restrict__ Lyf,
              const float* __restrict__ Lyb, const float* __restrict__ Rzf,
              const float* __restrict__ Rzb, const float* __restrict__ dinvp,
              int B, int NX, int NY, int NZ) {
  slab_body<NBUF, true>(t, Lyf, Lyb, Rzf, Rzb, dinvp, B, NX, NY, NZ);
}

// --- the apply ---------------------------------------------------------------------

constexpr int kApplyThreads = 512;
constexpr int kMaxBandMarch = 8;    // the march's register rings: bands 0..8
constexpr int kAhead = 4;           // planes in flight ahead of the march

// The left z halo of a w row: the band rounded up to even, so each
// thread's pair of z values sits on a float2 boundary.
__host__ __device__ constexpr int z_halo(int band) { return band + (band & 1); }

// Marker bytes per row of the march's padded marker (bcq): whole 16-byte
// chunks, so a plane's rows move with one bulk copy.
__host__ __device__ constexpr int marker_row(int NZ) { return (NZ + 15) & ~15; }

// Shared memory of the march (see packed_apply_march): the chunk's Ktx
// band rows, the tile's Kty band rows, sxy of every plane row it loads, sz,
// Ktz's band by d, kAhead + 1 raw slots (a plane's rows as in memory, x
// as floats and bc as bytes) and BAND + 1 w slots.
__host__ __device__ constexpr size_t march_smem(int band, int zl, int chunk) {
  const size_t yt = kApplyThreads / (zl / 2), hr = yt + 2 * band;
  return sizeof(uint64_t) * 2 * (kAhead + 1) +
         sizeof(float) * ((chunk + yt) * band_pad(band) +
                          round4((chunk + 2 * band) * hr) + zl +
                          (2 * band + 1) * zl + (kAhead + 1) * (hr * zl + 8) +
                          (band + 1) * hr * (zl + 2 * z_halo(band))) +
         (kAhead + 1) * hr * zl;
}

// A block of 512 threads owns an x-chunk and a tile of YT y-rows over all
// z (ZL = 32 or 64 z values, a pair per thread) and marches along x. Plane
// xn's rows of the tile and its halo are one contiguous range of x (and
// of the marker padded to 16-byte rows, bcq): they arrive by bulk copy,
// kAhead planes ahead, into a ring of raw slots (issue, below); at its
// step the block converts the plane to w = bc ? 0 : x s3 in a ring of
// BAND + 1 w slots (the tile's rows and a BAND-row y halo, a zero z
// halo), each thread keeping its own pair's w, raw x and bc in register
// rings of 2 BAND + 1 planes, and sums the outputs of plane xo = xn -
// BAND: the x term from its register rings, the y and z terms from plane
// xo's w slot, every shared-memory access a float2 per pair (a warp's
// accesses fall on distinct banks). One barrier per plane (two at BAND =
// 0, where plane xo is the plane just converted). The march runs in
// groups of the ring length (static_for), so every ring index is a
// compile-time register.
// Kxb[x][d] = Ktx[x, x - BAND + d] (zero outside the matrix), and Kyb,
// Kzb likewise, each row padded to DP = band_pad(BAND) floats.
template <int BAND, int ZL>
__global__ void __launch_bounds__(kApplyThreads, 1)
packed_apply_march(const float* __restrict__ x,
                   const unsigned char* __restrict__ bcq,
                   const float* __restrict__ sxy, const float* __restrict__ sz,
                   const float* __restrict__ Kxb,
                   const float* __restrict__ Kyb,
                   const float* __restrict__ Kzb, float* __restrict__ out,
                   int NX, int NY, int NZ, int chunk, float sigma) {
  constexpr int D = 2 * BAND + 1, DP = band_pad(BAND);
  constexpr int TPR = ZL / 2;              // threads per y-row
  constexpr int YT = kApplyThreads / TPR;  // y-rows of the tile
  constexpr int HR = YT + 2 * BAND;        // rows of a slot
  constexpr int PL = z_halo(BAND);         // left z halo of a w row
  constexpr int RW = ZL + 2 * PL;          // a w row
  constexpr int NR = kAhead + 1;           // raw slots
  constexpr int RC = HR * ZL + 8;          // floats of a raw slot
  constexpr int NW = BAND + 1;             // w slots
  constexpr int OFF = PL - BAND;           // z = z0 - BAND sits at z0 + OFF
  constexpr int NF2 = (OFF + D + 2) / 2;   // float2 loads of the z window
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, t = tid % TPR, r = tid / TPR;
  const int z0 = 2 * t;
  const int y0 = blockIdx.x * YT, y = y0 + r;
  const int x0 = blockIdx.y * chunk, x1 = min(x0 + chunk, NX);
  const int NZb = marker_row(NZ);
  const int64_t N = (int64_t)NX * NY * NZ;
  const float* xb = x + blockIdx.z * N;
  float* ob = out + blockIdx.z * N;
  const int xn0 = x0 - BAND, xn1 = x1 + BAND;   // planes the march loads
  const int ylo = max(y0 - BAND, 0), yhi = min(y0 + YT + BAND, NY);
  uint64_t* sBar = reinterpret_cast<uint64_t*>(smem);  // [NR] slot barriers
  float* sKx = smem + 4 * NR;                   // [chunk][DP]
  float* sKy = sKx + chunk * DP;                // [YT][DP]
  float* sSxy = sKy + YT * DP;                  // [chunk + 2 BAND][HR]
  float* sSz = sSxy + round4((chunk + 2 * BAND) * HR);  // [ZL]
  float* sKz = sSz + ZL;                        // [D][ZL] Ktz[z, z - BAND + d]
  float* sRaw = sKz + D * ZL;                   // [NR][RC], 16-byte aligned
  float* sW = sRaw + NR * RC;                   // [NW][HR][RW]
  unsigned char* sBc =
      reinterpret_cast<unsigned char*>(sW + NW * HR * RW);  // [NR][HR][ZL]

  for (int i = tid; i < chunk * DP; i += kApplyThreads) {
    const int xx = x0 + i / DP;
    sKx[i] = xx < NX ? Kxb[xx * DP + i % DP] : 0.f;
  }
  for (int i = tid; i < YT * DP; i += kApplyThreads) {
    const int yy = y0 + i / DP;
    sKy[i] = yy < NY ? Kyb[yy * DP + i % DP] : 0.f;
  }
  for (int i = tid; i < (chunk + 2 * BAND) * HR; i += kApplyThreads) {
    const int xx = xn0 + i / HR, yy = y0 - BAND + i % HR;
    sSxy[i] = xx >= 0 && xx < NX && yy >= 0 && yy < NY ? sxy[xx * NY + yy]
                                                        : 0.f;
  }
  for (int i = tid; i < ZL; i += kApplyThreads) sSz[i] = i < NZ ? sz[i] : 0.f;
  for (int i = tid; i < D * ZL; i += kApplyThreads) {
    const int d = i / ZL, zz = i % ZL;
    sKz[i] = zz < NZ ? Kzb[zz * DP + d] : 0.f;
  }
  for (int i = tid; i < NW * HR * RW; i += kApplyThreads) sW[i] = 0.f;
  const float sz0 = z0 < NZ ? sz[z0] : 0.f;
  const float sz1 = z0 + 1 < NZ ? sz[z0 + 1] : 0.f;

  // The 16-byte chunk of x holding plane xn's row ylo, and the row's
  // offset in floats from it.
  auto plane_base = [&](int xn, int& off) {
    const float* g = xb + ((int64_t)xn * NY + ylo) * NZ;
    off = (int)((reinterpret_cast<uintptr_t>(g) & 15) >> 2);
    return g - off;
  };
  // Plane xn's rows [ylo, yhi) of x and of the marker into raw slot `slot`:
  // their whole 16-byte chunks by one bulk copy each (thread 0), the at
  // most three floats at either end of x's range by 4-byte cp.async. The
  // slot's barrier completes once per plane, in or out of the lattice.
  auto issue = [&](int xn, int slot) {
    const bool in = xn < xn1 && xn >= 0 && xn < NX;
    int off = 0;
    const float* g = in ? plane_base(xn, off) : x;
    const int n = in ? off + (yhi - ylo) * NZ : 0;   // floats from g
    const int h = in ? min(4, n) : 0;                // the first chunk
    const int t4 = n > 4 ? n & ~3 : h;               // the last chunk's start
    float* R = sRaw + slot * RC;
    if (tid == 0) {
      const unsigned xbytes = 4u * (t4 - h), bbytes = in ? (yhi - ylo) * NZb : 0;
      mbar_expect(sBar + slot, xbytes + bbytes);
      if (xbytes) bulk_copy(R + h, g + h, xbytes, sBar + slot);
      if (bbytes)
        bulk_copy(sBc + slot * HR * ZL,
                  bcq + ((int64_t)xn * NY + ylo) * NZb, bbytes, sBar + slot);
    } else if (tid <= 8) {
      const int i = tid <= 4 ? tid - 1 : t4 + tid - 5;   // head, then tail
      if (i >= off && i < (tid <= 4 ? h : n)) cp_async4(R + i, g + i, true);
    }
  };
  // The pair (srow, zz) of plane xn in raw slot `rs` as w into w slot
  // `ws`: its raw x in v, its marker bits returned (bit 8 e for z = zz + e).
  auto convert = [&](int rs, int ws, int xn, float sv, int srow, int zz,
                     float2 s2, float2& w, float2& v) {
    const int yy = y0 - BAND + srow;
    unsigned b = 0;
    v = make_float2(0.f, 0.f);
    if (xn >= 0 && xn < NX && yy >= 0 && yy < NY) {
      int off;
      plane_base(xn, off);
      const float* R = sRaw + rs * RC + off + (yy - ylo) * NZ + zz;
      if (zz < NZ) v.x = R[0];
      if (zz + 1 < NZ) v.y = R[1];
      b = *reinterpret_cast<const unsigned short*>(
          sBc + rs * HR * ZL + (yy - ylo) * NZb + zz);
    }
    w.x = b & 0xffu ? 0.f : v.x * (sv * s2.x);
    w.y = b >> 8 ? 0.f : v.y * (sv * s2.y);
    *reinterpret_cast<float2*>(sW + (ws * HR + srow) * RW + PL + zz) = w;
    return b;
  };

  if (tid == 0) {
    for (int i = 0; i < NR; ++i) mbar_init(sBar + i);
    mbar_fence_init();
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    issue(xn0 + s, s);
    cp_async_commit();
  }
  float ring0[D], ring1[D];   // w of (z0, z0 + 1) at plane xn0 + s (mod D)
  float xr0[D], xr1[D];       // raw x, likewise
  unsigned m0 = 0, m1 = 0;    // bc, likewise, bit s
#pragma unroll
  for (int d = 0; d < D; ++d) ring0[d] = ring1[d] = xr0[d] = xr1[d] = 0.f;
  const bool out_ok = y < NY;
  int rs = 0, ws = 0;         // the raw and w slots of plane xn
  for (int xb0 = xn0; xb0 < xn1; xb0 += D) {
    static_for<0, D>([&](auto step) {
      constexpr int s = decltype(step)::value;
      const int xn = xb0 + s;
      if (xn >= xn1) return;
      cp_async_wait<kAhead - 1>();            // plane xn has landed
      mbar_wait(sBar + rs, ((xn - xn0) / NR) & 1);
      __syncthreads();
      issue(xn + kAhead, rs + kAhead < NR ? rs + kAhead : rs + kAhead - NR);
      cp_async_commit();
      const float* sp = sSxy + (xn - xn0) * HR;
      {
        float2 w, v;
        const unsigned b = convert(rs, ws, xn, sp[r + BAND], r + BAND, z0,
                                   make_float2(sz0, sz1), w, v);
        ring0[s] = w.x;
        ring1[s] = w.y;
        xr0[s] = v.x;
        xr1[s] = v.y;
        m0 = (m0 & ~(1u << s)) | (b & 0xffu ? 1u << s : 0u);
        m1 = (m1 & ~(1u << s)) | (b >> 8 ? 1u << s : 0u);
      }
      for (int h = tid; h < 2 * BAND * TPR; h += kApplyThreads) {
        const int hr = h / TPR, srow = hr < BAND ? hr : hr + YT;
        const int zz = 2 * (h % TPR);
        float2 w, v;
        convert(rs, ws, xn, sp[srow], srow, zz,
                *reinterpret_cast<const float2*>(sSz + zz), w, v);
      }
      const int wo = ws + 1 < NW ? ws + 1 : 0;  // the w slot of plane xn - BAND
      if (++rs == NR) rs = 0;
      ws = wo;
      if (BAND == 0) __syncthreads();
      const int xo = xn - BAND;
      if (xo < x0) return;
      // x term: the register rings against the plane's Ktx band row.
      const float4* kx4 = reinterpret_cast<const float4*>(sKx + (xo - x0) * DP);
      float tx0 = 0.f, tx1 = 0.f;
#pragma unroll
      for (int q = 0; q < DP / 4; ++q) {
        const float4 c = kx4[q];
        const float cs[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 4 * q + e;
          if (d < D) {
            tx0 = fmaf(cs[e], ring0[(s + 1 + d) % D], tx0);
            tx1 = fmaf(cs[e], ring1[(s + 1 + d) % D], tx1);
          }
        }
      }
      // y term: the pair's column of rows y - BAND .. y + BAND of plane xo.
      const float* Wo = sW + wo * HR * RW;
      const float4* ky4 = reinterpret_cast<const float4*>(sKy + r * DP);
      float ty0 = 0.f, ty1 = 0.f;
#pragma unroll
      for (int q = 0; q < DP / 4; ++q) {
        const float4 c = ky4[q];
        const float cs[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 4 * q + e;
          if (d < D) {
            const float2 v =
                *reinterpret_cast<const float2*>(Wo + (r + d) * RW + PL + z0);
            ty0 = fmaf(cs[e], v.x, ty0);
            ty1 = fmaf(cs[e], v.y, ty1);
          }
        }
      }
      // z term: row y of plane xo, z0 - BAND .. z0 + 1 + BAND.
      const float2* Wr =
          reinterpret_cast<const float2*>(Wo + (r + BAND) * RW + z0);
      float vz[2 * NF2];
#pragma unroll
      for (int i = 0; i < NF2; ++i) {
        const float2 v = Wr[i];
        vz[2 * i] = v.x;
        vz[2 * i + 1] = v.y;
      }
      float tz0 = 0.f, tz1 = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float2 k = *reinterpret_cast<const float2*>(sKz + d * ZL + z0);
        tz0 = fmaf(k.x, vz[OFF + d], tz0);
        tz1 = fmaf(k.y, vz[OFF + d + 1], tz1);
      }
      constexpr int k = (s + BAND + 1) % D;     // ring slot of plane xo
      float a0 = tx0 + ty0, a1 = tx1 + ty1;
      a0 = a0 + tz0;
      a1 = a1 + tz1;
      if (sigma != 0.f) {
        a0 = a0 + sigma * ring0[k];
        a1 = a1 + sigma * ring1[k];
      }
      if (!out_ok) return;
      const float sv = sSxy[(xo - xn0) * HR + r + BAND];
      float* o = ob + ((int64_t)xo * NY + y) * NZ + z0;
      if (z0 < NZ) o[0] = (m0 >> k) & 1u ? xr0[k] : a0 * (sv * sz0);
      if (z0 + 1 < NZ) o[1] = (m1 >> k) & 1u ? xr1[k] : a1 * (sv * sz1);
    });
  }
  cp_async_wait<0>();
}

// Bands above kMaxBandMarch: one thread per output, the same sums.
__global__ void __launch_bounds__(256)
packed_apply_direct(const float* __restrict__ x,
                    const unsigned char* __restrict__ bcq,
                    const float* __restrict__ sxy, const float* __restrict__ sz,
                    const float* __restrict__ Kxb, const float* __restrict__ Kyb,
                    const float* __restrict__ Kzb, float* __restrict__ out,
                    int B, int NX, int NY, int NZ, int band, float sigma) {
  const int DP = band_pad(band), D = 2 * band + 1, NZb = marker_row(NZ);
  const int64_t N = (int64_t)NX * NY * NZ;
  for (int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; g < B * N;
       g += (int64_t)gridDim.x * blockDim.x) {
    const int64_t b = g / N;
    const int cell = (int)(g - b * N);
    const int i = cell / (NY * NZ), j = (cell / NZ) % NY, k = cell % NZ;
    const float* xb = x + b * N;
    auto marked = [&](int ii, int jj, int kk) {
      return bcq[(ii * NY + jj) * NZb + kk] != 0;
    };
    auto w = [&](int ii, int jj, int kk) {
      return marked(ii, jj, kk)
                 ? 0.f
                 : xb[(ii * NY + jj) * NZ + kk] * (sxy[ii * NY + jj] * sz[kk]);
    };
    float tx = 0.f, ty = 0.f, tz = 0.f;
    for (int d = 0; d < D; ++d) {
      const int ii = i - band + d;
      if (ii >= 0 && ii < NX) tx = fmaf(Kxb[i * DP + d], w(ii, j, k), tx);
    }
    for (int d = 0; d < D; ++d) {
      const int jj = j - band + d;
      if (jj >= 0 && jj < NY) ty = fmaf(Kyb[j * DP + d], w(i, jj, k), ty);
    }
    for (int d = 0; d < D; ++d) {
      const int kk = k - band + d;
      if (kk >= 0 && kk < NZ) tz = fmaf(Kzb[k * DP + d], w(i, j, kk), tz);
    }
    float a = tx + ty;
    a = a + tz;
    if (sigma != 0.f) a = a + sigma * w(i, j, k);
    out[g] = marked(i, j, k) ? xb[cell] : a * (sxy[i * NY + j] * sz[k]);
  }
}

// --- launch helpers ------------------------------------------------------------------

// Raise a kernel's dynamic shared memory limit to what it asks for (above
// 48 KB a launch is refused without it); done once per kernel and size.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes,
                       std::atomic<size_t>& raised) {
  if (bytes <= raised.load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) raised.store(bytes, std::memory_order_relaxed);
  return e;
}

int sm_count() {
  static std::atomic<int> cached{0};
  int n = cached.load(std::memory_order_relaxed);
  if (n > 0) return n;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n <= 0)
    n = 1;
  cached.store(n, std::memory_order_relaxed);
  return n;
}

// Resident blocks per SM of a persistent kernel at `smem` bytes, cached on
// the last size asked.
template <typename Kernel>
int resident(Kernel kernel, int threads, size_t smem,
             std::atomic<long long>& cache) {
  const long long c = cache.load(std::memory_order_relaxed);
  if (c > 0 && (size_t)(c >> 8) == smem) return (int)(c & 255);
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    smem) != cudaSuccess ||
      n <= 0)
    n = 1;
  cache.store(((long long)smem << 8) | n, std::memory_order_relaxed);
  return n;
}

struct XPlan {
  int blocks, ct, tpt;
  size_t smem;
};
struct FdmPlan {
  XPlan fwd, bwd;
  int slab_blocks, nbuf;
  bool pair;                          // fdm_slab_pair: two blocks a slab
  size_t slab_smem;
};

constexpr size_t kMaxSmem = 232448;   // a block's shared memory on sm_90

bool extents_ok(int B, int NX, int NY, int NZ) {
  return B >= 1 && B <= kMaxBatch && NX >= 1 && NX <= kMaxN && NY >= 1 &&
         NY <= kMaxN && NZ >= 1 && NZ <= kMaxNZ;
}

// The shared memory limit, resident blocks per SM and waves of one x-pass
// instantiation.
template <bool BWD, int TPT, int CT>
cudaError_t x_candidate(int B, int NX, int NY, int NZ, XPlan& p) {
  static std::atomic<size_t> raised{0};
  static std::atomic<long long> occ{0};
  p.ct = CT;
  p.tpt = TPT;
  p.smem = x_pass_smem(NX, CT, BWD);
  const cudaError_t e = allow_smem(fdm_x_pass<BWD, TPT, CT>, p.smem, raised);
  if (e != cudaSuccess) return e;
  const int64_t tiles = (int64_t)B * ((NY * round4(NZ) + CT - 1) / CT);
  const int64_t slots =
      (int64_t)resident(fdm_x_pass<BWD, TPT, CT>, kXThreads, p.smem, occ) *
      sm_count();
  p.blocks = (int)std::min(tiles, slots);
  return cudaSuccess;
}

// An x pass's tile width: the least waves x columns per tile (32 or 64
// columns; a 64-column tile of a lattice with NX > 64 takes two 4 x 4
// output tiles per thread), the wider tile on a tie.
template <bool BWD>
cudaError_t x_plan(int B, int NX, int NY, int NZ, XPlan& best) {
  XPlan p32, p64;
  cudaError_t e = x_candidate<BWD, 1, 32>(B, NX, NY, NZ, p32);
  if (e == cudaSuccess)
    e = round4(NX) > 64 ? x_candidate<BWD, 2, 64>(B, NX, NY, NZ, p64)
                        : x_candidate<BWD, 1, 64>(B, NX, NY, NZ, p64);
  if (e != cudaSuccess) return e;
  const int64_t ncol = (int64_t)NY * round4(NZ);
  auto cost = [&](const XPlan& p) {
    const int64_t tiles = B * ((ncol + p.ct - 1) / p.ct);
    return (tiles + p.blocks - 1) / p.blocks * p.ct;
  };
  best = cost(p32) < cost(p64) ? p32 : p64;
  return cudaSuccess;
}

cudaError_t fdm_plan(int B, int NX, int NY, int NZ, FdmPlan& p) {
  static std::atomic<size_t> raised_s2{0}, raised_s3{0};
  static std::atomic<long long> occ_s2{0}, occ_s3{0};
  cudaError_t e = x_plan<false>(B, NX, NY, NZ, p.fwd);
  if (e == cudaSuccess) e = x_plan<true>(B, NX, NY, NZ, p.bwd);
  if (e != cudaSuccess) return e;
  p.nbuf = slab_smem(NY, NZ, 3) <= kMaxSmem ? 3 : 2;
  p.slab_smem = slab_smem(NY, NZ, p.nbuf);
  static std::atomic<size_t> raised_p2{0}, raised_p3{0};
  e = p.nbuf == 3 ? allow_smem(fdm_slab_pass<3>, p.slab_smem, raised_s3)
                  : allow_smem(fdm_slab_pass<2>, p.slab_smem, raised_s2);
  if (e == cudaSuccess)
    e = p.nbuf == 3 ? allow_smem(fdm_slab_pair<3>, p.slab_smem, raised_p3)
                    : allow_smem(fdm_slab_pair<2>, p.slab_smem, raised_p2);
  if (e != cudaSuccess) return e;
  const int sres = p.nbuf == 3
                       ? resident(fdm_slab_pass<3>, kSThreads, p.slab_smem, occ_s3)
                       : resident(fdm_slab_pass<2>, kSThreads, p.slab_smem, occ_s2);
  // Pairs when every slab's two blocks fit the card at once.
  const int64_t slots = (int64_t)sres * sm_count(), slabs = (int64_t)B * NX;
  p.pair = 2 * slabs <= slots;
  p.slab_blocks = (int)(p.pair ? 2 * slabs : std::min(slabs, slots));
  return cudaSuccess;
}

template <bool BWD>
cudaError_t launch_x(const XPlan& p, const float* in, const float* L,
                     const float* src, const unsigned char* bcp, float* out,
                     int B, int NX, int NY, int NZ, cudaStream_t s) {
  if (p.ct == 32)
    fdm_x_pass<BWD, 1, 32><<<p.blocks, kXThreads, p.smem, s>>>(
        in, L, src, bcp, out, B, NX, NY, NZ);
  else if (p.tpt == 1)
    fdm_x_pass<BWD, 1, 64><<<p.blocks, kXThreads, p.smem, s>>>(
        in, L, src, bcp, out, B, NX, NY, NZ);
  else
    fdm_x_pass<BWD, 2, 64><<<p.blocks, kXThreads, p.smem, s>>>(
        in, L, src, bcp, out, B, NX, NY, NZ);
  return cudaGetLastError();
}

// The dynamic shared memory a march instantiation is allowed, raised (never
// lowered) by its launches and by the occupancy query alike.
template <int BAND, int ZL>
std::atomic<size_t> march_raised{0};

template <int BAND, int ZL>
cudaError_t launch_march(const float* x, const unsigned char* bc,
                         const float* sxy, const float* sz, const float* Kxb,
                         const float* Kyb, const float* Kzb, float* out, int B,
                         int NX, int NY, int NZ, int chunk, float sigma,
                         cudaStream_t stream) {
  const size_t smem = march_smem(BAND, ZL, chunk);
  const cudaError_t e =
      allow_smem(packed_apply_march<BAND, ZL>, smem, march_raised<BAND, ZL>);
  if (e != cudaSuccess) return e;
  constexpr int YT = kApplyThreads / (ZL / 2);
  const dim3 grid((unsigned)((NY + YT - 1) / YT),
                  (unsigned)((NX + chunk - 1) / chunk), (unsigned)B);
  packed_apply_march<BAND, ZL><<<grid, kApplyThreads, smem, stream>>>(
      x, bc, sxy, sz, Kxb, Kyb, Kzb, out, NX, NY, NZ, chunk, sigma);
  return cudaGetLastError();
}

template <int BAND>
cudaError_t launch_march_zl(const float* x, const unsigned char* bc,
                            const float* sxy, const float* sz,
                            const float* Kxb, const float* Kyb,
                            const float* Kzb, float* out, int B, int NX,
                            int NY, int NZ, int chunk, float sigma,
                            cudaStream_t stream) {
  if (NZ <= 32)
    return launch_march<BAND, 32>(x, bc, sxy, sz, Kxb, Kyb, Kzb, out, B, NX,
                                  NY, NZ, chunk, sigma, stream);
  return launch_march<BAND, 64>(x, bc, sxy, sz, Kxb, Kyb, Kzb, out, B, NX, NY,
                                NZ, chunk, sigma, stream);
}

template <int BAND>
int march_resident(int NZ, int chunk) {
  const int zl = NZ <= 32 ? 32 : 64;
  const size_t smem = march_smem(BAND, zl, chunk);
  int n = 0;
  cudaError_t e;
  if (zl == 32) {
    e = allow_smem(packed_apply_march<BAND, 32>, smem, march_raised<BAND, 32>);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, packed_apply_march<BAND, 32>, kApplyThreads, smem);
  } else {
    e = allow_smem(packed_apply_march<BAND, 64>, smem, march_raised<BAND, 64>);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, packed_apply_march<BAND, 64>, kApplyThreads, smem);
  }
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace

extern "C" {

int packed_max_n() { return kMaxN; }
int packed_max_nz() { return kMaxNZ; }
int packed_max_batch() { return kMaxBatch; }
int packed_max_band_march() { return kMaxBandMarch; }

// Resident blocks per SM of the apply march at this band, NZ and chunk
// (its launch plan's input), or -(CUDA error).
int packed_apply_resident(int band, int NZ, int chunk) {
  switch (band) {
    case 0: return march_resident<0>(NZ, chunk);
    case 1: return march_resident<1>(NZ, chunk);
    case 2: return march_resident<2>(NZ, chunk);
    case 3: return march_resident<3>(NZ, chunk);
    case 4: return march_resident<4>(NZ, chunk);
    case 5: return march_resident<5>(NZ, chunk);
    case 6: return march_resident<6>(NZ, chunk);
    case 7: return march_resident<7>(NZ, chunk);
    case 8: return march_resident<8>(NZ, chunk);
    default: return 0;
  }
}

// y = A x per right-hand side: one launch. chunk: the x-planes a march
// block owns (ops/kron_packed.py: apply_plan); unused above
// kMaxBandMarch.
int packed_apply_launch(const float* x, const unsigned char* bc,
                        const float* sxy, const float* sz, const float* Kxb,
                        const float* Kyb, const float* Kzb, float* out, int B,
                        int NX, int NY, int NZ, int band, int chunk,
                        float sigma, void* stream) {
  if (!extents_ok(B, NX, NY, NZ) || band < 0 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define PACKED_MARCH(BD)                                                     \
  case BD:                                                                   \
    return (int)launch_march_zl<BD>(x, bc, sxy, sz, Kxb, Kyb, Kzb, out, B,   \
                                    NX, NY, NZ, chunk, sigma, s);
  switch (band) {
    PACKED_MARCH(0) PACKED_MARCH(1) PACKED_MARCH(2) PACKED_MARCH(3)
    PACKED_MARCH(4) PACKED_MARCH(5) PACKED_MARCH(6) PACKED_MARCH(7)
    PACKED_MARCH(8)
    default: break;
  }
#undef PACKED_MARCH
  const int64_t total = (int64_t)B * NX * NY * NZ;
  const unsigned blocks =
      (unsigned)std::min((total + 255) / 256, (int64_t)sm_count() * 16);
  packed_apply_direct<<<blocks, 256, 0, s>>>(x, bc, sxy, sz, Kxb, Kyb, Kzb,
                                             out, B, NX, NY, NZ, band, sigma);
  return (int)cudaGetLastError();
}

// The FDM's launch plan at these extents: {x-forward blocks, its tile
// columns, x-backward blocks, its tile columns, slab-pass blocks, slab
// buffers, the three kernels' shared bytes (x-forward, slab, x-backward),
// whether the slab pass runs in pairs}.
int packed_fdm_plan(int B, int NX, int NY, int NZ, long long* info) {
  if (!extents_ok(B, NX, NY, NZ)) return (int)cudaErrorInvalidValue;
  FdmPlan p;
  const cudaError_t e = fdm_plan(B, NX, NY, NZ, p);
  if (e != cudaSuccess) return (int)e;
  const long long v[10] = {p.fwd.blocks, p.fwd.ct, p.bwd.blocks, p.bwd.ct,
                           p.slab_blocks, p.nbuf, (long long)p.fwd.smem,
                           (long long)p.slab_smem, (long long)p.bwd.smem,
                           p.pair};
  for (int i = 0; i < 10; ++i) info[i] = v[i];
  return 0;
}

// y = bc ? b : A^{-1} b per right-hand side: three launches; t is a
// scratch batch (B, NX, NY, NZp), bcp the marker padded like it.
int packed_fdm_launch(const float* b, const unsigned char* bcp,
                      const float* Lxf, const float* Lxb, const float* Lyf,
                      const float* Lyb, const float* Rzf, const float* Rzb,
                      const float* dinvp, float* t, float* out, int B, int NX,
                      int NY, int NZ, void* stream) {
  if (!extents_ok(B, NX, NY, NZ)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  FdmPlan p;
  cudaError_t e = fdm_plan(B, NX, NY, NZ, p);
  if (e != cudaSuccess) return (int)e;
  e = launch_x<false>(p.fwd, b, Lxf, nullptr, nullptr, t, B, NX, NY, NZ, s);
  if (e != cudaSuccess) return (int)e;
  if (p.pair && p.nbuf == 3)
    fdm_slab_pair<3><<<p.slab_blocks, kSThreads, p.slab_smem, s>>>(
        t, Lyf, Lyb, Rzf, Rzb, dinvp, B, NX, NY, NZ);
  else if (p.pair)
    fdm_slab_pair<2><<<p.slab_blocks, kSThreads, p.slab_smem, s>>>(
        t, Lyf, Lyb, Rzf, Rzb, dinvp, B, NX, NY, NZ);
  else if (p.nbuf == 3)
    fdm_slab_pass<3><<<p.slab_blocks, kSThreads, p.slab_smem, s>>>(
        t, Lyf, Lyb, Rzf, Rzb, dinvp, B, NX, NY, NZ);
  else
    fdm_slab_pass<2><<<p.slab_blocks, kSThreads, p.slab_smem, s>>>(
        t, Lyf, Lyb, Rzf, Rzb, dinvp, B, NX, NY, NZ);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return (int)launch_x<true>(p.bwd, t, Lxb, b, bcp, out, B, NX, NY, NZ, s);
}

}  // extern "C"
