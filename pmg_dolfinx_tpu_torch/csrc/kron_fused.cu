// Hand-written Hopper (sm_90a) kernel for the whole-lattice Kronecker-sum
// apply.
//
// Replaces the Pallas kernel of pmg_dolfinx_tpu/ops/pallas_kron.py:
//   kron_fused  <- _kernel (PallasKronLaplacian)
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
// 3.35 TB/s.
//
// Design. One launch, one thread per output, z fastest across a warp.
// Every output depends on x only, so no two blocks need to meet: each
// thread forms its three line sums over the nonzero range [lo, hi) of its
// rows of Kx, Ky and Kz (ops/kron_fused.py:band_ranges, from the matrices
// themselves) reading x and the marker straight from global memory; at the
// headline size x (8.2 MB) and the marker (2 MB) stay in the 50 MB L2, and
// the z-line reads of a warp overlap in L1. The mass planes scale the sums
// and the Dirichlet rows copy x in the epilogue. Sums run in true f32 FMA
// (precision="highest"), term by term in the TPU kernel's order; only the
// order inside each line sum differs from a dense product. There is no
// padding and no size limit: the JAX class's VMEM bound on the lattice
// (pallas_kron.py:17-19) has no counterpart here.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTZ = 32, kTY = 8;

__device__ __forceinline__ float masked(const float* __restrict__ x,
                                        const unsigned char* __restrict__ bc,
                                        int64_t p) {
  return bc[p] ? 0.f : x[p];
}

__global__ void __launch_bounds__(kTZ * kTY)
kron_fused(const float* __restrict__ x, const unsigned char* __restrict__ bc,
           const float* __restrict__ Kx, const float* __restrict__ Ky,
           const float* __restrict__ Kz, const int* __restrict__ rng,
           const float* __restrict__ myz, const float* __restrict__ mxz,
           const float* __restrict__ mxy, float* __restrict__ out, int NX,
           int NY, int NZ) {
  const int k = blockIdx.x * kTZ + threadIdx.x;
  const int j = blockIdx.y * kTY + threadIdx.y;
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
  const float y = s1 * myz[(int64_t)j * NZ + k] +
                  s2 * mxz[(int64_t)i * NZ + k] + s3 * mxy[(int64_t)i * NY + j];
  out[g] = bc[g] ? x[g] : y;
}

}  // namespace

extern "C" {

// out = where(bc, x, y) on an (NX, NY, NZ) lattice; Kx (NX, NX), Ky (NY,
// NY), Kz (NZ, NZ) row-major; rng the int32 nonzero row ranges as above;
// myz (NY, NZ), mxz (NX, NZ), mxy (NX, NY).
int kron_fused_launch(const float* x, const unsigned char* bc,
                      const float* Kx, const float* Ky, const float* Kz,
                      const int* rng, const float* myz, const float* mxz,
                      const float* mxy, float* out, int NX, int NY, int NZ,
                      void* stream) {
  const dim3 grid((unsigned)((NZ + kTZ - 1) / kTZ),
                  (unsigned)((NY + kTY - 1) / kTY), (unsigned)NX);
  kron_fused<<<grid, dim3(kTZ, kTY), 0, (cudaStream_t)stream>>>(
      x, bc, Kx, Ky, Kz, rng, myz, mxz, mxy, out, NX, NY, NZ);
  return (int)cudaGetLastError();
}

}  // extern "C"
