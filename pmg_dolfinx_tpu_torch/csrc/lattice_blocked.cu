// Hand-written Hopper (sm_90a) kernels for the general-hex (curved) apply.
//
// Replaces the Pallas kernels of pmg_dolfinx_tpu/ops/pallas_lattice_blocked.py:
//   K-A  lattice_apply       <- _kernel_lattice_yx  ('yexp', the default)
//                               _kernel_lattice     ('v1')
//                               _kernel_lattice_ym  ('ym')
//        The three TPU kernels differ only in how they lay the same y = A x
//        out over VMEM and the MXU; on this card one kernel computes it.
//   K-B  lattice_apply_geom  <- _kernel_lattice_geom ('geom'): the same y,
//        with G rebuilt per quadrature point from 37 floats per cell.
//   K-A  lattice_apply_zgrp  <- _kernel_lattice_zg ('zgrp'): the same y,
//        with G in the TPU kernel's z-grouped layout Gz (Qx, 6*ngz, Qy,
//        zb*n). The TPU kernel groups z so that its MXU contracts small
//        shared group matrices instead of the dense (NZ, Qz) pair; here the
//        z contraction is already cell by cell, so K-A reads Gz in place:
//        point qz = cz*n + iz lies in group qz / (zb*n) at column
//        qz % (zb*n). Only the geometry's addressing differs.
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
// 294^3 * 6 * 4 B = 610 MB per apply, x and y ~130 MB, the cell-expanded
// partial sums below ~205 MB; ~0.28 ms at 3.35 TB/s against ~0.04 ms of
// f32 arithmetic at 67 TFLOP/s: memory-bound, and G is most of the bytes.
// K-B reads 37 floats per cell (11 MB at nc=42) in place of G and spends
// ~120 more flops per point on J, its adjugate, det J and K K^T: ~5.5
// GFLOP per apply, ~0.08 ms at the f32 peak, against ~0.1 ms of the
// remaining bytes; neither bound dominates by much, and division and
// register pressure decide in practice.
//
// Design.
// 1. lattice_cells<N, GEO>: a block owns one (cx, cy) cell column and a
//    chunk of ZC(N) cells along z; thread (qz, j) owns the x-line
//    (i = 0..n-1) of one (j, k) point of one cell, qz = cell * n + k. z is
//    fastest across threads, so the reads of x, of G (layout
//    (6, Qx, Qy, Qz), runs of ZC*n floats along z; with Gz the runs break
//    where a chunk crosses a z-group) and the writes of the partial sums
//    coalesce. GEO picks the geometry: kGt, kZgrp read it, kGeom
//    rebuilds it. The chunk's bc-zeroed dof values sit in shared
//    memory; the y and z derivatives read it, the x derivative too (the
//    same column). The t vectors go to shared memory for the transposed
//    sums. Each cell writes its n^3 partial results to a cell-expanded
//    lattice (Qx, Qy, Qz), the layout of G.
// 2. lattice_fold: one thread per dof gathers the 1-8 partial results of
//    the cells sharing it, in a fixed order, and applies the bc epilogue.
//    No atomics: the result is the same on every run (the overlap-add of
//    the reference's atomicAdd scatter, made deterministic as the JAX
//    package's fold_axis0 does it).
// Sums run in true f32 FMA on the CUDA cores (precision="highest"); they
// differ from the plain torch version (dense einsums) only in order.
//
// Every C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (cudaErrorInvalidValue for a degree that
// is not compiled) so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCo = 37;     // per-cell coefficients of K-B

// Where K-A finds the geometry of a quadrature point.
constexpr int kGt = 0;      // G (6, Qx, Qy, Qz)                    (K-A)
constexpr int kGeom = 1;    // rebuilt from co (37, ncx, ncy, ncz)  (K-B)
constexpr int kZgrp = 2;    // Gz (Qx, 6*ngz, Qy, zb*n), z-grouped  (K-A)

// Cells per block along z: ~42 z-threads per j-row of threads.
template <int N>
__host__ __device__ constexpr int zc() { return 42 / N > 0 ? 42 / N : 1; }

template <int N, int GEO>
__global__ void __launch_bounds__(N * N * zc<N>())
lattice_cells(const float* __restrict__ x, const unsigned char* __restrict__ bc,
              const float* __restrict__ G, const float* __restrict__ co,
              const float* __restrict__ D1, const float* __restrict__ gll,
              float* __restrict__ ycells, int ncx, int ncy, int ncz, int zbn) {
  constexpr bool GEOM = GEO == kGeom;
  constexpr int ZC = zc<N>();
  constexpr int W = ZC * N;            // z-extent of the chunk (points)
  constexpr int P = N - 1;
  __shared__ float su[N][N][W];        // bc-zeroed dof values (i, j, qz)
  __shared__ float stx[N][N][W];
  __shared__ float sty[N][N][W];
  __shared__ float stz[N][N][W];
  __shared__ float sD[N][N];
  __shared__ float sq[2][N];           // GLL points, weights (K-B)
  __shared__ float sco[GEOM ? kCo : 1][ZC];

  const int qz = threadIdx.x, j = threadIdx.y;
  const int tid = j * W + qz;
  const int cz0 = blockIdx.x * ZC, cy = blockIdx.y, cx = blockIdx.z;
  const int cl = qz / N, k = qz - cl * N;   // cell in chunk, z-point in cell
  const int cz = cz0 + cl;
  const bool valid = cz < ncz;
  const int NY = ncy * P + 1, NZ = ncz * P + 1;
  const int64_t Qy = (int64_t)ncy * N, Qz = (int64_t)ncz * N;
  const int64_t Qx = (int64_t)ncx * N;

  if (tid < N * N) sD[tid / N][tid % N] = D1[tid];
  if constexpr (GEOM) {
    if (tid < 2 * N) sq[tid / N][tid % N] = gll[tid];
    for (int t = tid; t < kCo * ZC; t += N * W) {
      const int e = t / ZC, c = t % ZC;
      sco[e][c] = (cz0 + c < ncz)
          ? co[(((int64_t)e * ncx + cx) * ncy + cy) * ncz + cz0 + c] : 0.f;
    }
  }
  const int gy = cy * P + j, gz = cz * P + k;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float v = 0.f;
    if (valid) {
      const int64_t g = ((int64_t)(cx * P + i) * NY + gy) * NZ + gz;
      v = bc[g] ? 0.f : x[g];
    }
    su[i][j][qz] = v;
  }
  __syncthreads();

  const int qb = qz - k;                    // first z-point of this cell
  const int64_t qy = (int64_t)cy * N + j, qzg = (int64_t)cz0 * N + qz;
  // kZgrp: Gz[qx][e * ngz + grp][qy][w], the point qzg = grp * zbn + w.
  const int ngz = GEO == kZgrp ? ncz * N / zbn : 1;
  const int grp = GEO == kZgrp ? (int)qzg / zbn : 0;
  const int64_t zrow = ((int64_t)grp * Qy + qy) * zbn + (qzg - (int64_t)grp * zbn);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float ux = 0.f, uy = 0.f, uz = 0.f;
#pragma unroll
    for (int m = 0; m < N; ++m) {
      ux = fmaf(sD[i][m], su[m][j][qz], ux);
      uy = fmaf(sD[j][m], su[i][m][qz], uy);
      uz = fmaf(sD[k][m], su[i][j][qb + m], uz);
    }
    float g0 = 0.f, g1 = 0.f, g2 = 0.f, g3 = 0.f, g4 = 0.f, g5 = 0.f;
    if (valid) {
      if constexpr (GEOM) {
        // J[r][c] = A + B s + C t + D s t over the two reference
        // coordinates free for column c: (eta, zeta), (xi, zeta), (xi, eta).
        const float xi = sq[0][i], eta = sq[0][j], zeta = sq[0][k];
        float J[3][3];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float s = c == 0 ? eta : xi;
            const float t = c == 2 ? eta : zeta;
            const int b = (r * 3 + c) * 4;
            J[r][c] = sco[b][cl] + sco[b + 1][cl] * s + sco[b + 2][cl] * t +
                      sco[b + 3][cl] * s * t;
          }
        }
        const float a = J[0][0], bb = J[0][1], c = J[0][2];
        const float d = J[1][0], e = J[1][1], f = J[1][2];
        const float g = J[2][0], h = J[2][1], ii = J[2][2];
        // Adjugate K = det J * J^{-1} (fem/geometry.py:_adjugate_3x3).
        const float K00 = e * ii - f * h, K01 = -(bb * ii - c * h),
                    K02 = bb * f - c * e;
        const float K10 = -(d * ii - f * g), K11 = a * ii - c * g,
                    K12 = -(a * f - c * d);
        const float K20 = d * h - e * g, K21 = -(a * h - bb * g),
                    K22 = a * e - bb * d;
        const float det = a * K00 + d * K01 + g * K02;
        const float scale =
            sq[1][i] * sq[1][j] * sq[1][k] * sco[kCo - 1][cl] / det;
        g0 = (K00 * K00 + K01 * K01 + K02 * K02) * scale;
        g1 = (K10 * K00 + K11 * K01 + K12 * K02) * scale;
        g2 = (K20 * K00 + K21 * K01 + K22 * K02) * scale;
        g3 = (K10 * K10 + K11 * K11 + K12 * K12) * scale;
        g4 = (K20 * K10 + K21 * K11 + K22 * K12) * scale;
        g5 = (K20 * K20 + K21 * K21 + K22 * K22) * scale;
      } else if constexpr (GEO == kZgrp) {
        const int64_t e = (int64_t)ngz * Qy * zbn;
        const int64_t o = ((int64_t)cx * N + i) * 6 * e + zrow;
        g0 = G[o];
        g1 = G[o + e];
        g2 = G[o + 2 * e];
        g3 = G[o + 3 * e];
        g4 = G[o + 4 * e];
        g5 = G[o + 5 * e];
      } else {
        const int64_t e = Qx * Qy * Qz;
        const int64_t o = (((int64_t)cx * N + i) * Qy + qy) * Qz + qzg;
        g0 = G[o];
        g1 = G[o + e];
        g2 = G[o + 2 * e];
        g3 = G[o + 3 * e];
        g4 = G[o + 4 * e];
        g5 = G[o + 5 * e];
      }
    }
    stx[i][j][qz] = g0 * ux + g1 * uy + g2 * uz;
    sty[i][j][qz] = g1 * ux + g3 * uy + g4 * uz;
    stz[i][j][qz] = g2 * ux + g4 * uy + g5 * uz;
  }
  __syncthreads();
  if (!valid) return;

#pragma unroll
  for (int i = 0; i < N; ++i) {
    float y = 0.f;
#pragma unroll
    for (int m = 0; m < N; ++m) {
      y = fmaf(sD[m][i], stx[m][j][qz], y);
      y = fmaf(sD[m][j], sty[i][m][qz], y);
      y = fmaf(sD[m][k], stz[i][j][qb + m], y);
    }
    ycells[(((int64_t)cx * N + i) * Qy + qy) * Qz + qzg] = y;
  }
}

// The cell-expanded positions of dof g along one axis: 1 or 2 entries.
__device__ __forceinline__ int cell_points(int g, int nc, int P, int q[2]) {
  const int n = P + 1;
  if (g == nc * P) {
    q[0] = (nc - 1) * n + P;
    return 1;
  }
  const int c = g / P, l = g - c * P;
  if (l == 0 && c > 0) {
    q[0] = (c - 1) * n + P;
    q[1] = c * n;
    return 2;
  }
  q[0] = c * n + l;
  return 1;
}

constexpr int kFoldZ = 32, kFoldY = 8;

__global__ void __launch_bounds__(kFoldZ * kFoldY)
lattice_fold(const float* __restrict__ ycells, const float* __restrict__ x,
             const unsigned char* __restrict__ bc, float* __restrict__ out,
             int P, int ncx, int ncy, int ncz, int apply_bc) {
  const int NY = ncy * P + 1, NZ = ncz * P + 1;
  const int gz = blockIdx.x * kFoldZ + threadIdx.x;
  const int gy = blockIdx.y * kFoldY + threadIdx.y;
  const int gx = blockIdx.z;
  if (gy >= NY || gz >= NZ) return;
  const int64_t g = ((int64_t)gx * NY + gy) * NZ + gz;
  if (apply_bc && bc[g]) {
    out[g] = x[g];
    return;
  }
  const int64_t Qy = (int64_t)ncy * (P + 1), Qz = (int64_t)ncz * (P + 1);
  int qx[2], qy[2], qz[2];
  const int nx = cell_points(gx, ncx, P, qx);
  const int ny = cell_points(gy, ncy, P, qy);
  const int nz = cell_points(gz, ncz, P, qz);
  float s = 0.f;
  for (int a = 0; a < nx; ++a)
    for (int b = 0; b < ny; ++b)
      for (int c = 0; c < nz; ++c)
        s += ycells[((int64_t)qx[a] * Qy + qy[b]) * Qz + qz[c]];
  out[g] = s;
}

template <int N, int GEO>
void launch_cells(const float* x, const unsigned char* bc, const float* G,
                  const float* co, const float* D1, const float* gll,
                  float* ycells, int ncx, int ncy, int ncz, int zbn,
                  cudaStream_t stream) {
  constexpr int ZC = zc<N>();
  const dim3 grid((unsigned)((ncz + ZC - 1) / ZC), (unsigned)ncy,
                  (unsigned)ncx);
  lattice_cells<N, GEO><<<grid, dim3(ZC * N, N), 0, stream>>>(
      x, bc, G, co, D1, gll, ycells, ncx, ncy, ncz, zbn);
}

// zb: cells per z-group (kZgrp only; the kernel takes zb * (P+1)).
template <int GEO>
int apply(const float* x, const unsigned char* bc, const float* G,
          const float* co, const float* D1, const float* gll, float* ycells,
          float* out, int P, int ncx, int ncy, int ncz, int zb, int apply_bc,
          cudaStream_t stream) {
  const int zbn = zb * (P + 1);
  switch (P) {
    case 1: launch_cells<2, GEO>(x, bc, G, co, D1, gll, ycells, ncx, ncy, ncz, zbn, stream); break;
    case 2: launch_cells<3, GEO>(x, bc, G, co, D1, gll, ycells, ncx, ncy, ncz, zbn, stream); break;
    case 3: launch_cells<4, GEO>(x, bc, G, co, D1, gll, ycells, ncx, ncy, ncz, zbn, stream); break;
    case 4: launch_cells<5, GEO>(x, bc, G, co, D1, gll, ycells, ncx, ncy, ncz, zbn, stream); break;
    case 5: launch_cells<6, GEO>(x, bc, G, co, D1, gll, ycells, ncx, ncy, ncz, zbn, stream); break;
    case 6: launch_cells<7, GEO>(x, bc, G, co, D1, gll, ycells, ncx, ncy, ncz, zbn, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int NX = ncx * P + 1, NY = ncy * P + 1, NZ = ncz * P + 1;
  const dim3 grid((unsigned)((NZ + kFoldZ - 1) / kFoldZ),
                  (unsigned)((NY + kFoldY - 1) / kFoldY), (unsigned)NX);
  lattice_fold<<<grid, dim3(kFoldZ, kFoldY), 0, stream>>>(
      ycells, x, bc, out, P, ncx, ncy, ncz, apply_bc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K-A: out = A x with the weighted geometry Gt (6, Qx, Qy, Qz).
// ycells is (Qx, Qy, Qz) scratch.
int lattice_apply_launch(const float* x, const unsigned char* bc,
                         const float* Gt, const float* D1, float* ycells,
                         float* out, int P, int ncx, int ncy, int ncz,
                         int apply_bc, void* stream) {
  return apply<kGt>(x, bc, Gt, nullptr, D1, nullptr, ycells, out, P, ncx,
                    ncy, ncz, 1, apply_bc, (cudaStream_t)stream);
}

// K-A on the z-grouped geometry Gz (Qx, 6*ngz, Qy, zb*(P+1)), ngz = ncz/zb.
int lattice_apply_zgrp_launch(const float* x, const unsigned char* bc,
                              const float* Gz, const float* D1,
                              float* ycells, float* out, int P, int ncx,
                              int ncy, int ncz, int zb, int apply_bc,
                              void* stream) {
  if (zb <= 0 || ncz % zb) return (int)cudaErrorInvalidValue;
  return apply<kZgrp>(x, bc, Gz, nullptr, D1, nullptr, ycells, out, P, ncx,
                      ncy, ncz, zb, apply_bc, (cudaStream_t)stream);
}

// K-B: out = A x with G rebuilt from co (37, ncx, ncy, ncz); gll holds the
// n GLL points then the n GLL weights on [0, 1].
int lattice_apply_geom_launch(const float* x, const unsigned char* bc,
                              const float* co, const float* D1,
                              const float* gll, float* ycells, float* out,
                              int P, int ncx, int ncy, int ncz, int apply_bc,
                              void* stream) {
  return apply<kGeom>(x, bc, nullptr, co, D1, gll, ycells, out, P, ncx, ncy,
                      ncz, 1, apply_bc, (cudaStream_t)stream);
}

}  // extern "C"
