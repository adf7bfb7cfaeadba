// The reduced-precision feature mode of the PaiNN column message kernels
// (K1, K2, K6, K7; ops/precision.py): an instance's kP bf16 terms, its
// feature loads, the per-edge rounding, and the bf16 tensor-core product
// (mma.sync m16n8k16, f32 sums) that replaces 3xTF32 at one piece, as the
// TPU runs Precision.DEFAULT.  Everything here has internal linkage.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

// kP: 3 exact f32, 2 the sum of two bf16 terms, 1 bf16
template <int kP>
using FeatT = std::conditional_t<kP == 1, __nv_bfloat16, float>;

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The sum of _split_f32's kP terms of v (round to nearest even; the
// remainder v - hi is exact in f32)
template <int kP>
__device__ __forceinline__ float pieces(float v) {
  if constexpr (kP == 1) {
    return bf16r(v);
  } else if constexpr (kP == 2) {
    const float hi = bf16r(v);
    return hi + bf16r(v - hi);
  } else {
    return v;
  }
}

// A feature (or cotangent) of an instance's input as f32: bf16 widened
// (exact), f32 rounded to kP terms at kP = 2, else as it is
template <int kP>
__device__ __forceinline__ float feat(const FeatT<kP>* p) {
  if constexpr (kP == 1) {
    return __uint_as_float((uint32_t)*reinterpret_cast<const uint16_t*>(p)
                           << 16);
  } else {
    return pieces<kP>(*p);
  }
}

// the same through L2 only (ld.global.cg)
template <int kP>
__device__ __forceinline__ float feat_cg(const FeatT<kP>* p) {
  if constexpr (kP == 1) {
    return __uint_as_float(
        (uint32_t)__ldcg(reinterpret_cast<const unsigned short*>(p)) << 16);
  } else {
    return pieces<kP>(__ldcg(p));
  }
}

// two floats as a bf16x2 register, each rounded to nearest even; lo in
// the low half (the operand of the lower k or n index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// c += a b for one m16n8k16 tile in bf16 with f32 sums.  a: A fragment (4
// registers: rows gid and gid+8, columns 2 tig + {0, 1} and + 8); b: B
// fragment (2: rows 2 tig + {0, 1} and + 8, column gid); c as m16n8k8's.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace
