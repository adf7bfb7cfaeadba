// Shared pieces of the PaiNN column message kernels for Hopper (sm_90a):
// the forward body (colblock_message.cu: K1, K6, K20) and the backward body
// (colblock_message_bwd.cu: K2, K7, K15, K21).  Everything here has
// internal linkage; each source includes it once.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// one thread a feature: F % 32 == 0 and F <= kMaxThreads
constexpr int kMaxThreads = 256;
// registers a thread: 168 lets three blocks of 128 threads share an SM's
// 64K (the message kernels are bound by latency, so resident warps count)
constexpr int kMaxRegs = 168;
// float4 groups of FW_aug rows that a register instance keeps per thread
// (B+1 <= 24); other B take the instance that reads FW_aug through L1
constexpr int kRegB4 = 6;
constexpr float kPi = 3.14159265358979323846f;

// the three forms of the message backward
constexpr int kFused = 0;   // K2: geometry recomputed from R, emits dR
constexpr int kGeoRes = 1;  // K7: geometry chain from the stored geo
constexpr int kSrc = 2;     // K15, K21: emits the geo cotangent instead

struct KOffs {
  int o[10];
};

inline KOffs make_koffs(const int* koffs) {
  KOffs ko;
  for (int i = 0; i < 10; ++i) ko.o[i] = koffs[i];
  return ko;
}

// Per-slot geometry: channel c < B+1 of slot k of destination column col
// at rbf + col * col_r + k * slot_r + c * ch_r, direction component c at
// dir + col * col_d + k * slot_d + c * ch_d (K7's d channel is direction
// component 3 of the channel-major geo).
template <typename T>
struct GeoView {
  T* rbf;
  T* dir;
  size_t col_r, slot_r, ch_r, col_d, slot_d, ch_d;
  __device__ T* r(int col, int k, int c) const {
    return rbf + col * col_r + k * slot_r + c * ch_r;
  }
  __device__ T* d(int col, int k, int c) const {
    return dir + col * col_d + k * slot_d + c * ch_d;
  }
  __device__ T* at(int col, int k, int c, int B1) const {
    return c < B1 ? r(col, k, c) : d(col, k, c - B1);
  }
};

// the channel-major view of a packed geo [nx, ny, nch, Ktot]
template <typename T>
GeoView<T> packed_view(T* geo, int Ktot, int B1, int nch) {
  const size_t col = (size_t)nch * Ktot;
  return {geo, geo == nullptr ? nullptr : geo + (size_t)B1 * Ktot,
          col, 1, (size_t)Ktot, col, 1, (size_t)Ktot};
}

// the edge-major view of rbf_aug [nx, ny, Ktot, B+1] and dir [.., 3]
template <typename T>
GeoView<T> edge_view(T* rbf, T* dir, int Ktot, int B1) {
  return {rbf, dir, (size_t)Ktot * B1, (size_t)B1, 1,
          (size_t)Ktot * 3, 3, 1};
}

// The bucket c9 of slot k from 8 compares against the offsets (a loop that
// indexes them would give every thread a local-memory copy of them).
__device__ __forceinline__ int bucket_of(int k, const KOffs& ko) {
  return (k >= ko.o[1]) + (k >= ko.o[2]) + (k >= ko.o[3]) +
         (k >= ko.o[4]) + (k >= ko.o[5]) + (k >= ko.o[6]) +
         (k >= ko.o[7]) + (k >= ko.o[8]);
}

// 4-byte asynchronous copies global -> shared, in commit groups
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the cosine cutoff's cos(pi d / rc) and sin(pi d / rc): cospif and
// sinpif reduce their argument exactly (cosf would keep a local-memory
// frame for its slow path)
__device__ __forceinline__ float cos_cut(float d, float rc) {
  return cospif(d / rc);
}
__device__ __forceinline__ float sin_cut(float d, float rc) {
  return sinpif(d / rc);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) v += __shfl_xor_sync(0xffffffffu, v, sh);
  return v;
}

// The filter of one slot for thread f: w_p = rbf_aug . FW_aug[:, p*F + f]
// for the parts p = q, R, mu, from FW_aug's rows at fw + b * ld (global
// memory, or the backward's copy in shared memory).  kB4 > 0
// keeps the thread's 3 x 4 kB4 weights in registers (rows >= B+1 are 0);
// kB4 = 0 reads them for every slot.  The slot's basis row is read from
// shared memory as float4 broadcasts (every thread of the block reads the
// same row), padded with zeros to 4 n4.
template <int kB4>
struct Filter {
  float q[kB4 > 0 ? 4 * kB4 : 1], r[kB4 > 0 ? 4 * kB4 : 1],
      m[kB4 > 0 ? 4 * kB4 : 1];
  const float* fw;
  int F, ld, B1;

  __device__ __forceinline__ void load(const float* FW, int ld_, int B1_,
                                       int F_, int f) {
    fw = FW + f;
    F = F_;
    ld = ld_;
    B1 = B1_;
    if constexpr (kB4 > 0) {
#pragma unroll
      for (int b = 0; b < 4 * kB4; ++b) {
        const bool ok = b < B1_;
        const float* p = fw + (size_t)(ok ? b : 0) * ld_;
        q[b] = ok ? p[0] : 0.f;
        r[b] = ok ? p[F_] : 0.f;
        m[b] = ok ? p[2 * F_] : 0.f;
      }
    }
  }

  __device__ __forceinline__ void apply(const float4* rb, int n4, float& wq,
                                        float& wr, float& wm) const {
    float aq = 0.f, ar = 0.f, am = 0.f;
    if constexpr (kB4 > 0) {
#pragma unroll
      for (int g = 0; g < kB4; ++g) {
        if (g < n4) {
          const float4 v = rb[g];
          const int b = 4 * g;
          aq = fmaf(v.x, q[b], aq);
          ar = fmaf(v.x, r[b], ar);
          am = fmaf(v.x, m[b], am);
          aq = fmaf(v.y, q[b + 1], aq);
          ar = fmaf(v.y, r[b + 1], ar);
          am = fmaf(v.y, m[b + 1], am);
          aq = fmaf(v.z, q[b + 2], aq);
          ar = fmaf(v.z, r[b + 2], ar);
          am = fmaf(v.z, m[b + 2], am);
          aq = fmaf(v.w, q[b + 3], aq);
          ar = fmaf(v.w, r[b + 3], ar);
          am = fmaf(v.w, m[b + 3], am);
        }
      }
    } else {
      // rows past B+1 are 0 in the basis row: read row 0 for them
      for (int g = 0; g < n4; ++g) {
        const float4 v = rb[g];
        const int b = 4 * g;
        const float* p0 = fw + (size_t)b * ld;
        const float* p1 = b + 1 < B1 ? p0 + ld : fw;
        const float* p2 = b + 2 < B1 ? p0 + 2 * ld : fw;
        const float* p3 = b + 3 < B1 ? p0 + 3 * ld : fw;
        aq = fmaf(v.x, p0[0], aq);
        ar = fmaf(v.x, p0[F], ar);
        am = fmaf(v.x, p0[2 * F], am);
        aq = fmaf(v.y, p1[0], aq);
        ar = fmaf(v.y, p1[F], ar);
        am = fmaf(v.y, p1[2 * F], am);
        aq = fmaf(v.z, p2[0], aq);
        ar = fmaf(v.z, p2[F], ar);
        am = fmaf(v.z, p2[2 * F], am);
        aq = fmaf(v.w, p3[0], aq);
        ar = fmaf(v.w, p3[F], ar);
        am = fmaf(v.w, p3[2 * F], am);
      }
    }
    wq = aq;
    wr = ar;
    wm = am;
  }

  // the filters of U slots (basis rows rb + row[u] * n4) together: 3 U
  // independent FMA chains
  template <int U>
  __device__ __forceinline__ void apply_n(const float4* rb, const int (&row)[U],
                                          int n4, float (&wq)[U],
                                          float (&wr)[U],
                                          float (&wm)[U]) const {
    if constexpr (kB4 > 0) {
#pragma unroll
      for (int u = 0; u < U; ++u) wq[u] = wr[u] = wm[u] = 0.f;
#pragma unroll
      for (int g = 0; g < kB4; ++g) {
        if (g < n4) {
          float4 v[U];
#pragma unroll
          for (int u = 0; u < U; ++u) v[u] = rb[row[u] * n4 + g];
          const int b = 4 * g;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            wq[u] = fmaf(v[u].x, q[b], wq[u]);
            wr[u] = fmaf(v[u].x, r[b], wr[u]);
            wm[u] = fmaf(v[u].x, m[b], wm[u]);
            wq[u] = fmaf(v[u].y, q[b + 1], wq[u]);
            wr[u] = fmaf(v[u].y, r[b + 1], wr[u]);
            wm[u] = fmaf(v[u].y, m[b + 1], wm[u]);
            wq[u] = fmaf(v[u].z, q[b + 2], wq[u]);
            wr[u] = fmaf(v[u].z, r[b + 2], wr[u]);
            wm[u] = fmaf(v[u].z, m[b + 2], wm[u]);
            wq[u] = fmaf(v[u].w, q[b + 3], wq[u]);
            wr[u] = fmaf(v[u].w, r[b + 3], wr[u]);
            wm[u] = fmaf(v[u].w, m[b + 3], wm[u]);
          }
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u)
        apply(rb + row[u] * n4, n4, wq[u], wr[u], wm[u]);
    }
  }
};

// 3xTF32 on the tensor cores: v = big + small, big = v rounded to TF32,
// small = the remainder rounded to TF32; a product keeps big*big +
// big*small + small*big (three mma_tf32 into three accumulators), which
// is f32-accurate (~2^-22 relative against the ~2^-11 of one TF32
// product).
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  uint32_t b, s;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(b) : "f"(v));
  const float rest = v - __uint_as_float(b);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(s) : "f"(rest));
  big = b;
  small = s;
}

// c += a b for one m16n8k8 tile (a: A fragment, 4 TF32 registers; b: B
// fragment, 2)
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace
