// The bf16x3 split and dot of precision="high", shared by the HIGH
// instantiations of csrc/kron_blocked.cu and csrc/lattice_blocked.cu
// (ops/cuda_build.py puts this directory on the include path and hashes
// this header with every source).
#pragma once

#include <cuda_bf16.h>

namespace {

// a as (hi, lo) = (bf16_rn(a), bf16_rn(a - hi)), both round to nearest
// even as XLA's convert, packed into one word: hi's bits in the high half,
// lo's in the low half. The difference a - hi is taken as XLA takes it
// (subnormal operands count as zero, a subnormal result is flushed to a
// zero of its sign), so the split equals pallas_util.split_bf16 bit for
// bit.
__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < 1.17549435e-38f ? copysignf(0.f, v) : v;
}
__device__ __forceinline__ float split_pack(float a) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(a);
  const float daz_a = fabsf(a) < 1.17549435e-38f ? 0.f : a;
  const float h = __bfloat162float(hi);
  const __nv_bfloat16 lo =
      __float2bfloat16_rn(ftz(daz_a - (fabsf(h) < 1.17549435e-38f ? 0.f : h)));
  return __uint_as_float((unsigned)__bfloat16_as_ushort(hi) << 16 |
                         __bfloat16_as_ushort(lo));
}
__device__ __forceinline__ float hi_part(float p) {
  return __uint_as_float(__float_as_uint(p) & 0xffff0000u);
}
__device__ __forceinline__ float lo_part(float p) {
  return __uint_as_float(__float_as_uint(p) << 16);
}

// sum_d a_d b_d in bf16x3 over split_pack'ed operands: the three exact
// products in their own f32 accumulators, summed as hh + (hl + lh)
// (_dot3).
struct Acc3 {
  float hh = 0.f, hl = 0.f, lh = 0.f;
  __device__ __forceinline__ void add(float a, float b) {
    const float ah = hi_part(a), bh = hi_part(b);
    hh = fmaf(ah, bh, hh);
    hl = fmaf(ah, lo_part(b), hl);
    lh = fmaf(lo_part(a), bh, lh);
  }
  __device__ __forceinline__ float sum() const { return hh + (hl + lh); }
};

}  // namespace
