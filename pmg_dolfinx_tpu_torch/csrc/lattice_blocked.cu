// Hand-written Hopper (sm_90a) kernels for the general-hex (curved) apply.
//
// Replaces the Pallas kernels of pmg_dolfinx_tpu/ops/pallas_lattice_blocked.py:
//   K-A  lattice_march<N, kGt>    <- _kernel_lattice_yx  ('yexp', the default)
//                                    _kernel_lattice     ('v1')
//                                    _kernel_lattice_ym  ('ym')
//        The three TPU kernels differ only in how they lay the same y = A x
//        out over VMEM and the MXU; on this card one kernel computes it.
//   K-A  lattice_march<N, kZgrp>  <- _kernel_lattice_zg ('zgrp'): the same
//        y, with G in the TPU kernel's z-grouped layout Gz (Qx, 6*ngz, Qy,
//        zb*n). The TPU kernel groups z so that its MXU contracts small
//        shared group matrices instead of the dense (NZ, Qz) pair; here the
//        z contraction is already cell by cell, so K-A reads Gz in place:
//        point qz = cz*n + iz lies in group qz / (zb*n) at column
//        qz % (zb*n). Only the geometry's addressing differs.
//   K-B  lattice_march<N, kGeom>  <- _kernel_lattice_geom ('geom'): the same
//        y, with G rebuilt per quadrature point from 37 floats per cell.
//   Each apply also launches lattice_faces, which reads and writes only
//   the dofs that two or more blocks share (below).
//
// Operator (per cell, n = P+1 GLL points per axis, D = the 1D GLL
// derivative matrix D[q][m] = l_m'(x_q)):
//   u        = the cell's n^3 dof values, Dirichlet dofs zeroed
//   ux,uy,uz = sum_m D[i|j|k][m] u along x|y|z          (3n FMAs)
//   (tx,ty,tz) = G (ux,uy,uz), G the 6-entry symmetric   (15 flops)
//                weighted geometry factor of the point
//   y_cell   = sum_q D[q][i|j|k] t along x|y|z           (3n FMAs)
//   y        = overlap-add of y_cell over the 1, 2, 4 or 8 cells that
//              share each dof; Dirichlet rows copy x unless apply_bc=0.
//
// What bounds it on this card. K-A does ~100 flops per quadrature point
// and streams G at 24 bytes per point: at 16.2M dofs (nc=42, p=6) G is
// 294^3 * 6 * 4 B = 610 MB per apply, x, the marker and y ~146 MB; ~0.23
// ms at 3.35 TB/s against ~0.04 ms of f32 arithmetic at 67 TFLOP/s:
// memory-bound, and G is most of the bytes. K-B reads 37 floats per cell
// (11 MB at nc=42) in place of G and spends ~55 more flops per point on
// J, its adjugate, det J and K K^T (one reciprocal): neither its bytes nor
// its operations bound it by much. In practice the instruction rate of the
// shared-memory sums and the latency of each step's loads decide.
//
// Design: one streaming pass, no cell-expanded lattice.
// 1. A block owns a box of Sx x By x Bz cells and marches along x through
//    its Sx cells. Thread (ly, lz) owns the x-line of quadrature point
//    (j, k) of one (cy, cz) cell of the box: its n values of u and of t_x
//    stay in registers, so the x derivative and its transpose never touch
//    shared memory (the rows of D come as broadcast float4 reads), and the
//    x-face that cell cx shares with cx+1 is a register carried to the
//    next step (added first, then the new cell's plane 0: a fixed order).
//    z is fastest across threads, so the reads of x and of G coalesce
//    along z (Gz: a box never straddles a z-group, the plan makes Bz
//    divide zb). The next cell's x and marker bytes are fetched into
//    registers as soon as u is spent, and (K-A) its G is staged into
//    shared memory with cp.async (P >= 4) or fetched into registers (P <=
//    3), so the loads fly during the rest of the step; a marker byte
//    stays raw until its plane is used.
// 2. Per cell three block barriers: the bc-zeroed u (and its markers) are
//    published to shared memory for the y and z derivatives, then t_y and
//    t_z for their transposes, then the cell's y-line values for the fold.
//    The fold is a gather of the 1, 2 or 4 lines sharing each dof of the
//    box's (y, z) dof plane, in a fixed order, for every x-plane the step
//    finishes; the marker comes from shared memory, x from HBM only where
//    a Dirichlet row copies it.
// 3. A dof on a face between boxes (a face, edge or corner shared by 2, 4
//    or 8 boxes) goes to the face scratch instead: one slot per sharing
//    box, in arrays per set A of shared axes (the shared axes indexed by
//    2 * (boundary - 1) + side, the others by the dof). lattice_faces, one
//    thread per shared dof, sums its slots in the fixed order of the sides
//    and writes y there. Sums run in a fixed order everywhere, so two
//    applies give the same bits; no value is added atomically.
// Sums run in true f32 FMA on the CUDA cores (precision="highest"); they
// differ from the plain torch version (dense einsums) only in order.
//
// precision="high" (bf16x3, the TPU kernels' `high` flag). The same
// source built with -DPMG_HIGH=1 is a second library whose entry points
// launch lattice_march<N, GEO, true> (ops/lattice_blocked.py builds it the
// first time 'high' is asked for). The TPU kernels split both operands of
// each contraction they hand the MXU (_mk_dot: hi = bf16_rn(a), lo =
// bf16_rn(a - hi), the products hi*hi + (hi*lo + lo*hi) each summed in
// f32, lo*lo dropped); on this card's per-cell sums that is, per
// quadrature point and dof:
//   u   -> hi(u) + lo(u)              (the expansion dot with E, 0/1)
//   ux  =  sum D u                    (f32: the TPU kernel's VPU sum)
//   uy  =  'yexp', 'ym', 'zgrp', 'geom': sum D u (f32, block-D1 VPU sum);
//          'v1' (GEO kGtV1): bf16x3 sum D u (its Dy dot)
//   uz  =  bf16x3 sum u D (the DzT dot); 'v1' then hi + lo of it (its Ey)
//   bx  =  sum D^T t_x (f32)
//   s   =  bx + sum D^T t_y (f32) ; 'v1': hi(bx) + lo(bx) + bf16x3 sum
//          D^T t_y (its EyT and DyT dots)
//   y   =  hi(s) + lo(s) + bf16x3 sum t_z D^T (the Ez and Dz dots)
// and G, the geometry of K-B and the folds stay f32. 'v1' folds y across
// the cells of a y-face before its z dots split the sum; here each cell's
// value is split before the fold, which differs only in those last bits.
//
// Every C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (cudaErrorInvalidValue for a degree or a
// plan that is not supported) so the Python wrapper can raise. The face
// scratch holds lattice_scratch_bytes; it needs no initial value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16x3.cuh"  // split_pack, hi_part, lo_part, Acc3

#ifndef PMG_HIGH
#define PMG_HIGH 0
#endif

namespace {

// The instantiations this library's entry points launch (see the head).
constexpr bool kHigh = PMG_HIGH != 0;

// hi(a) + lo(a): a's product with a 0/1 matrix in bf16x3 (exact sum).
__device__ __forceinline__ float round16(float a) {
  const float p = split_pack(a);
  return hi_part(p) + lo_part(p);
}

constexpr int kCo = 37;             // per-cell coefficients of K-B
constexpr int kMaxSmem = 227 * 1024;  // dynamic shared memory per block
constexpr int kFaceThreads = 256;   // threads per block of lattice_faces

// Where K-A finds the geometry of a quadrature point.
constexpr int kGt = 0;      // G (6, Qx, Qy, Qz)                    (K-A)
constexpr int kGeom = 1;    // rebuilt from co (37, ncx, ncy, ncz)  (K-B)
constexpr int kZgrp = 2;    // Gz (Qx, 6*ngz, Qy, zb*n), z-grouped  (K-A)
constexpr int kGtV1 = 3;    // G as kGt, with 'v1''s splits (K-A, HIGH only)

// The launch plan and the face scratch's layout. Axis a = 0, 1, 2 is x,
// y, z; a set of shared axes A is a bit mask (x = 1, y = 2, z = 4). All
// offsets are 32-bit: make_plan refuses lattices whose G, or whose
// scratch, holds 2^31 floats or more.
struct Plan {
  int nc[3];        // cells
  int N[3];         // dofs
  int S[3];         // cells per box
  int nb[3];        // boxes
  int zbn;          // kZgrp: zb * (P+1)
  int apply_bc;
  int slot[8];      // float offset of set A's slot array (A = 1..7)
  int face[9];      // lattice_faces: first thread of set A; face[8] = all
};

__host__ __device__ inline int64_t slot_dim(const Plan& p, int A, int a) {
  return (A >> a & 1) ? 2 * (int64_t)(p.nb[a] - 1) : (int64_t)p.N[a];
}

// Fills the offsets of `p` (its nc, N, S, nb set); returns the scratch's
// floats.
__host__ inline int64_t layout(Plan& p) {
  int64_t off = 0, threads = 0;
  p.slot[0] = p.face[0] = 0;
  for (int A = 1; A < 8; ++A) {
    const int64_t size =
        slot_dim(p, A, 0) * slot_dim(p, A, 1) * slot_dim(p, A, 2);
    p.slot[A] = (int)off;
    p.face[A] = (int)threads;
    off += size;
    threads += size >> __builtin_popcount(A);
  }
  p.face[8] = (int)threads;
  return off;
}

// The slot of a dof shared along the axes of A: c[a] is the dof for an
// axis outside A, else 2 * (boundary - 1) + side; `off` the offset of A's
// slot array.
__device__ __forceinline__ int slot_index(const Plan& p, int off, int A,
                                          int c0, int c1, int c2) {
  return off + (c0 * (int)slot_dim(p, A, 1) + c1) * (int)slot_dim(p, A, 2) +
         c2;
}

// A row of N floats from shared memory (16-byte aligned, padded to a
// multiple of 4) into registers: ceil(N/4) vector loads, broadcast when
// the warp reads one row.
template <int N>
__device__ __forceinline__ void load_row(const float* row, float r[N]) {
  if constexpr (N <= 2) {
    const float2 v = *reinterpret_cast<const float2*>(row);
    r[0] = v.x;
    if (N > 1) r[N - 1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(row + q);
      r[q] = v.x;
      if (q + 1 < N) r[q + 1] = v.y;
      if (q + 2 < N) r[q + 2] = v.z;
      if (q + 3 < N) r[q + 3] = v.w;
    }
  }
}

// The z-pitch of a cell's lines in the block's shared arrays: N padded so
// that a line's z-neighbours in its cell load as float2 / float4 rows.
__host__ __device__ constexpr int zpitch(int N) {
  return N <= 2 ? 2 : (N + 3) / 4 * 4;
}

// A 4-byte asynchronous copy from global to shared memory (cp.async),
// its commit and the wait for all of this thread's copies.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// Whether K-A stages G through shared memory (at P >= 4; below, each
// line's next cell of G rides in registers, 6 n a thread), and the
// threads a block may have: 384 for K-A at P >= 4 (one block per SM of
// up to 168 registers a thread, which the unrolled sums of a degree-6
// line take without spilling), else 256 (two blocks per SM, 128
// registers). Measured on an H100 (tools/lattice_bench_torch.py --sweep).
__host__ __device__ constexpr bool stages_g(int N, int geo) {
  return geo != kGeom && N >= 5;
}

__host__ __device__ constexpr int max_threads(int N, int geo) {
  return geo != kGeom && N >= 5 ? 384 : 256;
}

__host__ __device__ constexpr int min_blocks(int N, int geo) {
  return geo != kGeom && N >= 5 ? 1 : 2;
}

// Dynamic shared memory of a block on boxes of BB (y, z) cells whose
// planes hold LP line slots (z-pitch zpitch(N) per cell): su, sty, stz,
// sy, then G (K-A, staged) or the box's coefficients (K-B), then two
// buffers of the markers.
__host__ __device__ inline size_t block_smem(int N, int geo, int LP,
                                             int BB) {
  const size_t extra = geo == kGeom       ? (size_t)kCo * BB
                       : stages_g(N, geo) ? (size_t)6 * N * LP
                                          : 0;
  return sizeof(float) * ((size_t)4 * N * LP + extra) + (size_t)2 * N * LP;
}

template <int N, int GEO, bool HIGH>
__global__ void __launch_bounds__(max_threads(N, GEO), min_blocks(N, GEO))
lattice_march(const float* __restrict__ x, const unsigned char* __restrict__ bc,
              const float* __restrict__ G, const float* __restrict__ co,
              const float* __restrict__ D1, const float* __restrict__ gll,
              float* __restrict__ out, float* __restrict__ slots,
              const Plan p) {
  constexpr bool GEOM = GEO == kGeom;
  constexpr bool STAGE = stages_g(N, GEO);
  constexpr bool GREG = !GEOM && !STAGE;
  constexpr bool V1 = GEO == kGtV1;
  constexpr int P = N - 1;
  constexpr int N4 = (N + 3) / 4 * 4;               // padded row
  constexpr int KC = (kCo + N * N - 1) / (N * N);  // coefficients a thread
  extern __shared__ float smem[];
  __shared__ __align__(16) float sD[N][N4];         // D[i][q]
  __shared__ __align__(16) float sDT[N][N4];        // D[q][i]
  // HIGH: the same, split_pack'ed.
  __shared__ __align__(16) float sDp[HIGH ? N : 1][N4];
  __shared__ __align__(16) float sDTp[HIGH ? N : 1][N4];
  __shared__ float sq[2][N];        // GLL points, weights (K-B)
  __shared__ int s_off[8];          // p.slot (indexed at run time)

  constexpr int ZP = zpitch(N);
  const int LZ = blockDim.x, L = LZ * blockDim.y;
  const int lz = threadIdx.x, ly = threadIdx.y, tid = ly * LZ + lz;
  const int BB = p.S[1] * p.S[2];
  // Shared arrays are [i][ly][czl][k] with k padded to ZP: plane LP, row
  // LZP; this thread's slot sl.
  const int LZP = p.S[2] * ZP, LP = blockDim.y * LZP;
  float* su = smem;                 // bc-zeroed u
  float* sty = su + N * LP;         // t_y
  float* stz = sty + N * LP;        // t_z
  float* sy = stz + N * LP;         // the cell's y
  float* sg = sy + N * LP;          // K-A: G            [e][i][slot]
  float* sco = sy + N * LP;         // K-B: [37][By*Bz]
  unsigned char* smk = reinterpret_cast<unsigned char*>(
      sy + N * LP + (GEOM ? kCo * BB : STAGE ? 6 * N * LP : 0));  // [2][i]

  const int b[3] = {(int)blockIdx.z, (int)blockIdx.y, (int)blockIdx.x};
  const int cx0 = b[0] * p.S[0];
  const int cx1 = min(cx0 + p.S[0], p.nc[0]);
  const int cy0 = b[1] * p.S[1], nyc = min(p.S[1], p.nc[1] - cy0);
  const int cz0 = b[2] * p.S[2], nzc = min(p.S[2], p.nc[2] - cz0);
  const int NYZ = p.N[1] * p.N[2];

  // This thread's quadrature line.
  const int cyl = ly / N, j = ly - cyl * N, czl = lz / N, k = lz - czl * N;
  const bool valid = cyl < nyc && czl < nzc;
  const int sl = ly * LZP + czl * ZP + k;
  const int line = ((cy0 + cyl) * P + j) * p.N[2] + (cz0 + czl) * P + k;
  // G of point (qx, line), entry e: G[qx * gsx + e * gse + gline].
  const int Qy = p.nc[1] * N, Qz = p.nc[2] * N;
  const int qy = (cy0 + cyl) * N + j, qz = (cz0 + czl) * N + k;
  int gsx, gse, gline;
  if constexpr (GEO == kZgrp) {
    const int grp = qz / p.zbn;
    gse = Qz / p.zbn * Qy * p.zbn;
    gsx = 6 * gse;
    gline = (grp * Qy + qy) * p.zbn + (qz - grp * p.zbn);
  } else {
    gse = p.nc[0] * N * Qy * Qz;
    gsx = Qy * Qz;
    gline = qy * Qz + qz;
  }

  for (int t = tid; t < N * N; t += L) {
    sD[t / N][t % N] = D1[t];
    sDT[t % N][t / N] = D1[t];
    if constexpr (HIGH) {
      sDp[t / N][t % N] = split_pack(D1[t]);
      sDTp[t % N][t / N] = split_pack(D1[t]);
    }
  }
  if (GEOM && tid < 2 * N) sq[tid / N][tid % N] = gll[tid];
  for (int t = tid; t < 8; t += L) s_off[t] = p.slot[t];

  // The fold. This line's dof (dy, dz) of the box's (y, z) dof plane is
  // also the dof of the lines of the neighbouring cells whose j or k is
  // 0 where this line's is P: the line with the lowest cells owns it and
  // adds theirs (ny, nz) from shared memory. side: -1 not shared with
  // another box, 1 on the box's low face (the upper box of boundary b), 0
  // on its high face (the lower box of boundary b + 1).
  const bool owner = valid && (j > 0 || cyl == 0) && (k > 0 || czl == 0);
  const bool ny = owner && j == P && cyl < nyc - 1;
  const bool nz = owner && k == P && czl < nzc - 1;
  const int dy = cyl * P + j, dz = czl * P + k;
  const int sidey = (dy == 0 && b[1] > 0) ? 1
      : (dy == nyc * P && b[1] < p.nb[1] - 1) ? 0 : -1;
  const int sidez = (dz == 0 && b[2] > 0) ? 1
      : (dz == nzc * P && b[2] < p.nb[2] - 1) ? 0 : -1;
  const int Ayz = (sidey >= 0) << 1 | (sidez >= 0) << 2;
  const int cys = sidey >= 0 ? 2 * (b[1] - sidey) + sidey : cy0 * P + dy;
  const int czs = sidez >= 0 ? 2 * (b[2] - sidez) + sidez : cz0 * P + dz;

  // Fetch cell cx into registers: x and the raw marker bytes of planes
  // i0..P (plane 0 of the next cell is plane P of this one), and K-B's
  // coefficients of the box's cells; stage its G (K-A).
  float u[N], cof[KC], gr[GREG ? 6 : 1][GREG ? N : 1];
  unsigned char m[N];
  auto fetch = [&](int cx, int i0) {
    if (valid) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if (i < i0) continue;
        const int o = (cx * P + i) * NYZ + line;
        u[i] = x[o];
        m[i] = bc[o];
      }
      if constexpr (GREG) {
        const float* gp = G + cx * N * gsx + gline;
#pragma unroll
        for (int i = 0; i < N; ++i)
#pragma unroll
          for (int e = 0; e < 6; ++e) gr[e][i] = gp[i * gsx + e * gse];
      }
    }
    if constexpr (GEOM) {
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int t = tid + c * L;
        if (t < kCo * BB) {
          const int e = t / BB, r = t - e * BB;
          const int yl = r / p.S[2], zl = r - yl * p.S[2];
          cof[c] = (yl < nyc && zl < nzc)
              ? co[((e * p.nc[0] + cx) * p.nc[1] + cy0 + yl) * p.nc[2] +
                   cz0 + zl]
              : 0.f;
        }
      }
    }
  };
  auto stage_g = [&](int cx) {
    if constexpr (STAGE) {
      if (valid) {
        const float* gp = G + cx * N * gsx + gline;
#pragma unroll
        for (int i = 0; i < N; ++i)
#pragma unroll
          for (int e = 0; e < 6; ++e)
            cp_async4(sg + (e * N + i) * LP + sl, gp + i * gsx + e * gse);
      }
      cp_async_commit();
    }
  };
#pragma unroll
  for (int i = 0; i < N; ++i) {
    u[i] = 0.f;
    m[i] = 0;
  }
  fetch(cx0, 0);
  stage_g(cx0);

  float carry = 0.f;
  for (int cx = cx0; cx < cx1; ++cx) {
    unsigned char* mk = smk + (cx & 1) * N * LP;
    // 1. Publish the bc-zeroed u, its markers (and K-B's coefficients).
#pragma unroll
    for (int i = 0; i < N; ++i) {
      u[i] = m[i] ? 0.f : u[i];
      if (HIGH) u[i] = round16(u[i]);
      su[i * LP + sl] = u[i];
      mk[i * LP + sl] = m[i];
    }
    if constexpr (GEOM) {
#pragma unroll
      for (int c = 0; c < KC; ++c)
        if (tid + c * L < kCo * BB) sco[tid + c * L] = cof[c];
    }
    if constexpr (STAGE) cp_async_wait_all();
    __syncthreads();

    // 2. Gradients and t = G grad u; t_x stays in registers.
    float tx[N];
    {
      float j0[3], a1[3], b1[3], a2[3], b2[3], wjk = 0.f;
      if constexpr (GEOM) {
        const float eta = sq[0][j], zeta = sq[0][k];
        const float* c0 = sco + cyl * p.S[2] + czl;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const float* A0 = c0 + ((r * 3 + 0) * 4) * BB;
          const float* A1 = c0 + ((r * 3 + 1) * 4) * BB;
          const float* A2 = c0 + ((r * 3 + 2) * 4) * BB;
          // J[r][0] over (eta, zeta); J[r][1] over (xi, zeta) and J[r][2]
          // over (xi, eta), each linear in xi along the line.
          j0[r] = A0[0] + A0[BB] * eta + A0[2 * BB] * zeta +
                  A0[3 * BB] * eta * zeta;
          a1[r] = A1[0] + A1[2 * BB] * zeta;
          b1[r] = A1[BB] + A1[3 * BB] * zeta;
          a2[r] = A2[0] + A2[2 * BB] * eta;
          b2[r] = A2[BB] + A2[3 * BB] * eta;
        }
        wjk = sq[1][j] * sq[1][k] * c0[(kCo - 1) * BB];
      }
      float Dj[N], Dk[N], Djp[HIGH ? N : 1], Dkp[HIGH ? N : 1];
      load_row<N>(sD[j], Dj);
      load_row<N>(sD[k], Dk);
      if constexpr (HIGH) {
        load_row<N>(sDp[j], Djp);
        load_row<N>(sDp[k], Dkp);
      }
      const float* uyp = su + cyl * N * LZP + czl * ZP + k;
      const float* uzp = su + ly * LZP + czl * ZP;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float Di[N], uk[N];
        load_row<N>(sD[i], Di);
        load_row<N>(uzp + i * LP, uk);
        float ux = 0.f, uy = 0.f, uz = 0.f;
        if constexpr (HIGH) {
          Acc3 ay, az;
#pragma unroll
          for (int q = 0; q < N; ++q) {
            ux = fmaf(Di[q], u[q], ux);
            const float vy = uyp[i * LP + q * LZP];
            if (V1)
              ay.add(Djp[q], split_pack(vy));
            else
              uy = fmaf(Dj[q], vy, uy);
            az.add(split_pack(uk[q]), Dkp[q]);
          }
          if (V1) uy = ay.sum();
          uz = V1 ? round16(az.sum()) : az.sum();
        } else {
#pragma unroll
          for (int q = 0; q < N; ++q) {
            ux = fmaf(Di[q], u[q], ux);
            uy = fmaf(Dj[q], uyp[i * LP + q * LZP], uy);
            uz = fmaf(Dk[q], uk[q], uz);
          }
        }
        float g0 = 0.f, g1 = 0.f, g2 = 0.f, g3 = 0.f, g4 = 0.f, g5 = 0.f;
        if (valid) {
          if constexpr (GEOM) {
            const float xi = sq[0][i];
            const float a = j0[0], bb = fmaf(b1[0], xi, a1[0]),
                        c = fmaf(b2[0], xi, a2[0]);
            const float d = j0[1], e = fmaf(b1[1], xi, a1[1]),
                        f = fmaf(b2[1], xi, a2[1]);
            const float gg = j0[2], h = fmaf(b1[2], xi, a1[2]),
                        ii = fmaf(b2[2], xi, a2[2]);
            // Adjugate K = det J * J^{-1} (fem/geometry.py:_adjugate_3x3).
            const float K00 = e * ii - f * h, K01 = -(bb * ii - c * h),
                        K02 = bb * f - c * e;
            const float K10 = -(d * ii - f * gg), K11 = a * ii - c * gg,
                        K12 = -(a * f - c * d);
            const float K20 = d * h - e * gg, K21 = -(a * h - bb * gg),
                        K22 = a * e - bb * d;
            const float det = a * K00 + d * K01 + gg * K02;
            const float scale = wjk * sq[1][i] * __frcp_rn(det);
            g0 = (K00 * K00 + K01 * K01 + K02 * K02) * scale;
            g1 = (K10 * K00 + K11 * K01 + K12 * K02) * scale;
            g2 = (K20 * K00 + K21 * K01 + K22 * K02) * scale;
            g3 = (K10 * K10 + K11 * K11 + K12 * K12) * scale;
            g4 = (K20 * K10 + K21 * K11 + K22 * K12) * scale;
            g5 = (K20 * K20 + K21 * K21 + K22 * K22) * scale;
          } else if constexpr (GREG) {
            g0 = gr[0][i];
            g1 = gr[1][i];
            g2 = gr[2][i];
            g3 = gr[3][i];
            g4 = gr[4][i];
            g5 = gr[5][i];
          } else {
            const float* gi = sg + i * LP + sl;
            g0 = gi[0];
            g1 = gi[N * LP];
            g2 = gi[2 * N * LP];
            g3 = gi[3 * N * LP];
            g4 = gi[4 * N * LP];
            g5 = gi[5 * N * LP];
          }
        }
        tx[i] = g0 * ux + g1 * uy + g2 * uz;
        sty[i * LP + sl] = g1 * ux + g3 * uy + g4 * uz;
        stz[i * LP + sl] = g2 * ux + g4 * uy + g5 * uz;
      }
    }
    // u and this thread's entries of sg are spent: the next cell's
    // operands fly during the rest of this step.
    if (cx + 1 < cx1) {
      u[0] = u[P];
      m[0] = m[P];
      fetch(cx + 1, 1);
      stage_g(cx + 1);
    }
    __syncthreads();

    // 3. The cell's y-line, the x-face carried in a register; the lines
    // that do not own their dofs hand their values to the owners.
    float yl[N];
    {
      float Djt[N], Dkt[N], Djtp[HIGH ? N : 1], Dktp[HIGH ? N : 1];
      load_row<N>(sDT[j], Djt);
      load_row<N>(sDT[k], Dkt);
      if constexpr (HIGH) {
        load_row<N>(sDTp[j], Djtp);
        load_row<N>(sDTp[k], Dktp);
      }
      const float* typ = sty + cyl * N * LZP + czl * ZP + k;
      const float* tzp = stz + ly * LZP + czl * ZP;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float Dit[N], tk[N];
        load_row<N>(sDT[i], Dit);
        load_row<N>(tzp + i * LP, tk);
        float y = 0.f;
        if constexpr (HIGH) {
          float bx = 0.f, by = 0.f;
          Acc3 ay, az;
#pragma unroll
          for (int q = 0; q < N; ++q) {
            bx = fmaf(Dit[q], tx[q], bx);
            const float ty = typ[i * LP + q * LZP];
            if (V1)
              ay.add(Djtp[q], split_pack(ty));
            else
              by = fmaf(Djt[q], ty, by);
            az.add(split_pack(tk[q]), Dktp[q]);
          }
          const float s = V1 ? round16(bx) + ay.sum() : bx + by;
          y = round16(s) + az.sum();
        } else {
#pragma unroll
          for (int q = 0; q < N; ++q) {
            y = fmaf(Dit[q], tx[q], y);
            y = fmaf(Djt[q], typ[i * LP + q * LZP], y);
            y = fmaf(Dkt[q], tk[q], y);
          }
        }
        if (i == 0) y = carry + y;
        if (i == P) carry = y;
        yl[i] = y;
        if (!owner) sy[i * LP + sl] = y;
      }
    }
    __syncthreads();

    // 4. Each owner folds the x-planes this step finishes (plane P too at
    // the box's last cell) for its dof, in the order of the lines' cells
    // (y, then z).
    if (owner) {
      const bool last = cx == cx1 - 1;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if (i == P && !last) continue;
        const float* s = sy + i * LP + sl;
        float v = yl[i];
        if (nz) v += s[ZP - P];
        if (ny) {
          v += s[LZP];
          if (nz) v += s[LZP + ZP - P];
        }
        const int gx = cx * P + i;
        const int sidex = (i == 0 && cx == cx0 && b[0] > 0) ? 1
            : (i == P && last && b[0] < p.nb[0] - 1) ? 0 : -1;
        const int A = Ayz | (sidex >= 0);
        if (A == 0) {
          const int o = gx * NYZ + line;
          out[o] = (p.apply_bc && mk[i * LP + sl]) ? x[o] : v;
        } else {
          slots[slot_index(p, s_off[A], A,
                           sidex >= 0 ? 2 * (b[0] - sidex) + sidex : gx,
                           cys, czs)] = v;
        }
      }
    }
  }
}

// The dofs that two or more boxes share: thread f of set A's range sums
// the 2^|A| slots of its dof (A's shared axes at side 0 enumerate them)
// in the fixed order of the sides and writes y there.
__global__ void __launch_bounds__(kFaceThreads)
lattice_faces(const float* __restrict__ x, const unsigned char* __restrict__ bc,
              const float* __restrict__ slots, float* __restrict__ out,
              const Plan p, int P) {
  const int f = blockIdx.x * kFaceThreads + threadIdx.x;
  if (f >= p.face[8]) return;
  int A = 1, first = 0, off = 0;
#pragma unroll
  for (int a = 1; a < 8; ++a) {
    if (f >= p.face[a]) {
      A = a;
      first = p.face[a];
      off = p.slot[a];
    }
  }
  int r = f - first, g[3], c[3];
#pragma unroll
  for (int a = 2; a >= 0; --a) {
    const bool sh = A >> a & 1;
    const int h = sh ? p.nb[a] - 1 : p.N[a];
    const int q = r / h, ca = r - q * h;
    r = q;
    const int SP = p.S[a] * P;
    // An axis outside A must not lie on a face between boxes there: that
    // dof belongs to another set.
    if (!sh && ca % SP == 0 && ca > 0 && ca < p.N[a] - 1) return;
    g[a] = sh ? (ca + 1) * SP : ca;
    c[a] = sh ? 2 * ca : ca;
  }
  int rank[3], n = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) rank[a] = (A >> a & 1) ? n++ : 31;
  const int o = (g[0] * p.N[1] + g[1]) * p.N[2] + g[2];
  const unsigned char m = bc[o];
  float part[8];
#pragma unroll
  for (int s = 0; s < 8; ++s)
    part[s] = s < 1 << n
        ? slots[slot_index(p, off, A, c[0] + (s >> rank[0] & 1),
                           c[1] + (s >> rank[1] & 1),
                           c[2] + (s >> rank[2] & 1))]
        : 0.f;
  float v = 0.f;
#pragma unroll
  for (int s = 0; s < 8; ++s) v += part[s];
  out[o] = (p.apply_bc && m) ? x[o] : v;
}

// Lets lattice_march<N, GEO, kHigh> take `smem` bytes of dynamic shared
// memory (above 48 KB only after an opt-in, made once per size and
// process).
template <int N, int GEO>
int opt_in(size_t smem) {
  static size_t granted = 48 * 1024;
  if (smem <= granted) return 0;
  const int err = (int)cudaFuncSetAttribute(
      lattice_march<N, GEO, kHigh>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == 0) granted = smem;
  return err;
}

template <int N, int GEO>
int launch(const float* x, const unsigned char* bc, const float* G,
           const float* co, const float* D1, const float* gll, float* out,
           float* scratch, const Plan& p, cudaStream_t stream) {
  const int LZ = p.S[2] * N, LY = p.S[1] * N;
  const size_t smem =
      block_smem(N, GEO, LY * p.S[2] * zpitch(N), p.S[1] * p.S[2]);
  if (LZ * LY > max_threads(N, GEO) || smem > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  int err = opt_in<N, GEO>(smem);
  if (err != 0) return err;
  const dim3 grid((unsigned)p.nb[2], (unsigned)p.nb[1], (unsigned)p.nb[0]);
  lattice_march<N, GEO, kHigh><<<grid, dim3(LZ, LY), smem, stream>>>(
      x, bc, G, co, D1, gll, out, scratch, p);
  err = (int)cudaGetLastError();
  if (err != 0 || p.face[8] == 0) return err;
  lattice_faces<<<(p.face[8] + kFaceThreads - 1) / kFaceThreads,
                  kFaceThreads, 0, stream>>>(x, bc, scratch, out, p, N - 1);
  return (int)cudaGetLastError();
}

// Fills `p` for degree P, cells nc and box S; false for a plan the
// kernels do not take.
bool make_plan(Plan& p, int P, int ncx, int ncy, int ncz, int Sx, int By,
               int Bz, int zb, int apply_bc) {
  const int nc[3] = {ncx, ncy, ncz}, S[3] = {Sx, By, Bz};
  if (P < 1 || P > 6) return false;
  for (int a = 0; a < 3; ++a) {
    if (nc[a] < 1 || S[a] < 1) return false;
    p.nc[a] = nc[a];
    p.N[a] = nc[a] * P + 1;
    p.S[a] = S[a] < nc[a] ? S[a] : nc[a];
    p.nb[a] = (nc[a] + p.S[a] - 1) / p.S[a];
  }
  if (p.nb[0] > 65535 || p.nb[1] > 65535) return false;
  p.zbn = zb * (P + 1);
  p.apply_bc = apply_bc;
  // 32-bit offsets: G (6 Q floats) and the scratch stay below 2^31.
  const int64_t Q = (int64_t)nc[0] * nc[1] * nc[2] * (P + 1) * (P + 1) *
                    (P + 1);
  return 6 * Q < INT32_MAX && layout(p) < INT32_MAX;
}

template <int GEO>
int apply(const float* x, const unsigned char* bc, const float* G,
          const float* co, const float* D1, const float* gll, float* out,
          void* scratch, int P, int ncx, int ncy, int ncz, int zb, int Sx,
          int By, int Bz, int apply_bc, cudaStream_t stream) {
  Plan p;
  if (!make_plan(p, P, ncx, ncy, ncz, Sx, By, Bz, zb, apply_bc))
    return (int)cudaErrorInvalidValue;
  float* s = static_cast<float*>(scratch);
  switch (P) {
    case 1: return launch<2, GEO>(x, bc, G, co, D1, gll, out, s, p, stream);
    case 2: return launch<3, GEO>(x, bc, G, co, D1, gll, out, s, p, stream);
    case 3: return launch<4, GEO>(x, bc, G, co, D1, gll, out, s, p, stream);
    case 4: return launch<5, GEO>(x, bc, G, co, D1, gll, out, s, p, stream);
    case 5: return launch<6, GEO>(x, bc, G, co, D1, gll, out, s, p, stream);
    case 6: return launch<7, GEO>(x, bc, G, co, D1, gll, out, s, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K-A on G: the 'v1' splits (kGtV1) when HIGH and asked for, else kGt;
// the 'highest' library instantiates no kGtV1 kernel.
template <bool H>
int apply_gt(const float* x, const unsigned char* bc, const float* Gt,
             const float* D1, float* out, void* scratch, int P, int ncx,
             int ncy, int ncz, int Sx, int By, int Bz, int apply_bc, int v1,
             cudaStream_t stream) {
  if constexpr (H) {
    if (v1)
      return apply<kGtV1>(x, bc, Gt, nullptr, D1, nullptr, out, scratch, P,
                          ncx, ncy, ncz, 1, Sx, By, Bz, apply_bc, stream);
  }
  return apply<kGt>(x, bc, Gt, nullptr, D1, nullptr, out, scratch, P, ncx,
                    ncy, ncz, 1, Sx, By, Bz, apply_bc, stream);
}

}  // namespace

extern "C" {

// Bytes of the face scratch of a plan (its slots), and through `faces`
// the threads of its lattice_faces launch; -1 for a plan the kernels do
// not take.
int64_t lattice_scratch_bytes(int P, int ncx, int ncy, int ncz, int Sx,
                              int By, int Bz, int64_t* faces) {
  Plan p;
  if (!make_plan(p, P, ncx, ncy, ncz, Sx, By, Bz, 1, 1)) return -1;
  *faces = p.face[8];
  return 4 * layout(p);
}

// K-A: out = A x with the weighted geometry Gt (6, Qx, Qy, Qz), on boxes
// of Sx x By x Bz cells; scratch of lattice_scratch_bytes. v1 != 0 in the
// HIGH library: the splits of the TPU's 'v1' kernel (see the head).
int lattice_apply_launch(const float* x, const unsigned char* bc,
                         const float* Gt, const float* D1, void* scratch,
                         float* out, int P, int ncx, int ncy, int ncz,
                         int Sx, int By, int Bz, int apply_bc, int v1,
                         void* stream) {
  return apply_gt<kHigh>(x, bc, Gt, D1, out, scratch, P, ncx, ncy, ncz, Sx,
                         By, Bz, apply_bc, v1, (cudaStream_t)stream);
}

// 1 in the precision="high" library (built with -DPMG_HIGH=1), else 0.
int lattice_high() { return kHigh ? 1 : 0; }

// K-A on the z-grouped geometry Gz (Qx, 6*ngz, Qy, zb*(P+1)), ngz = ncz/zb.
int lattice_apply_zgrp_launch(const float* x, const unsigned char* bc,
                              const float* Gz, const float* D1,
                              void* scratch, float* out, int P, int ncx,
                              int ncy, int ncz, int zb, int Sx, int By,
                              int Bz, int apply_bc, void* stream) {
  if (zb <= 0 || ncz % zb) return (int)cudaErrorInvalidValue;
  return apply<kZgrp>(x, bc, Gz, nullptr, D1, nullptr, out, scratch, P, ncx,
                      ncy, ncz, zb, Sx, By, Bz, apply_bc,
                      (cudaStream_t)stream);
}

// K-B: out = A x with G rebuilt from co (37, ncx, ncy, ncz); gll holds the
// n GLL points then the n GLL weights on [0, 1].
int lattice_apply_geom_launch(const float* x, const unsigned char* bc,
                              const float* co, const float* D1,
                              const float* gll, void* scratch, float* out,
                              int P, int ncx, int ncy, int ncz, int Sx,
                              int By, int Bz, int apply_bc, void* stream) {
  return apply<kGeom>(x, bc, nullptr, co, D1, gll, out, scratch, P, ncx, ncy,
                      ncz, 1, Sx, By, Bz, apply_bc, (cudaStream_t)stream);
}

// Blocks of K-A (geo 0), K-B (1) or K-A on Gz (2) one SM of the current
// card holds at degree P on boxes of By x Bz cells (the occupancy API);
// -1 for a plan the kernels do not take.
int lattice_blocks_per_sm(int geo, int P, int By, int Bz) {
  int blocks = -1;
  const int threads = By * Bz * (P + 1) * (P + 1);
  const size_t smem =
      block_smem(P + 1, geo, By * (P + 1) * Bz * zpitch(P + 1), By * Bz);
  if (threads > max_threads(P + 1, geo) || smem > (size_t)kMaxSmem)
    return -1;
#define LATTICE_OCC(NN)                                                      \
  case NN - 1:                                                              \
    if (geo == kGt && opt_in<NN, kGt>(smem) == 0)                           \
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(                        \
          &blocks, lattice_march<NN, kGt, kHigh>, threads, smem);           \
    else if (geo == kGeom && opt_in<NN, kGeom>(smem) == 0)                  \
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(                        \
          &blocks, lattice_march<NN, kGeom, kHigh>, threads, smem);         \
    else if (geo == kZgrp && opt_in<NN, kZgrp>(smem) == 0)                  \
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(                        \
          &blocks, lattice_march<NN, kZgrp, kHigh>, threads, smem);         \
    break;
  switch (P) {
    LATTICE_OCC(2)
    LATTICE_OCC(3)
    LATTICE_OCC(4)
    LATTICE_OCC(5)
    LATTICE_OCC(6)
    LATTICE_OCC(7)
    default: return -1;
  }
#undef LATTICE_OCC
  return blocks;
}

}  // extern "C"
