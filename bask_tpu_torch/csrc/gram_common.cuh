// What K1/K2 (gram.cu), K4 (gram_wb.cu) and K5 (pathwise.cu) share: the
// spec's flags, the Matern epilogue (so that every kernel forms an entry
// from d2 the same way) and the 3xTF32 tensor-core helpers of K4 and K5.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// sqrt.approx.f32: one MUFU operation, within 2^-23 relative of the root
// (IEEE sqrtf adds a refinement and a slow-path call that splits every
// entry's code into branches); d2 + 1e-36 is a normal float
__device__ __forceinline__ float sqrt_mufu(float x) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

template <int kNu>  // 0: nu = 1/2, 1: 3/2, 2: 5/2, 3: RBF
__device__ __forceinline__ float matern(float d2) {
  if (kNu == 3) return expf(-0.5f * d2);
  const float r = sqrt_mufu(d2 + 1e-36f);
  if (kNu == 0) return expf(-r);
  if (kNu == 1) {
    const float s = 1.7320508075688772f * r;
    return (1.0f + s) * expf(-s);
  }
  const float s = 2.23606797749979f * r;
  return (1.0f + s + s * s * (1.0f / 3.0f)) * expf(-s);
}

// n_real, read from its 1-element int32 device tensor: a captured launch
// (a CUDA graph) then computes with whatever count the tensor holds at
// replay, as the Pallas kernel reads n_real_arr by scalar prefetch. A count
// outside [0, n_pad] sets ``bad`` and returns 0; the kernels then write NaN
// in every masked entry, so the LML of such a gram is -inf (an int n_real
// is range-checked on the host before it becomes a tensor).
__device__ __forceinline__ int load_n_real(const int* n_real_p, int n_pad, bool& bad) {
  const int n = __ldg(n_real_p);
  bad = n < 0 || n > n_pad;
  return bad ? 0 : n;
}

__device__ __forceinline__ float nan_f32() { return __int_as_float(0x7fc00000); }

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits) to nearest,
// ties away from zero, as cvt.rna.tf32.f32 rounds, but by two integer
// operations on the bits (measured faster on the H100 than two cvt.rna);
// lo = x - hi exactly, of which the tensor cores read the top 10 mantissa
// bits (the low 13 are dropped), so hi + lo carries x to ~2^-21. A NaN x
// keeps a NaN lo.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Spec {
  int has_const;  // thetas[0] is log amp
  int has_white;  // thetas[off + n_ls] is log noise
  int n_ls;       // 1 (isotropic) or d lengthscales at thetas[off ..]
};

}  // namespace
