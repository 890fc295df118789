// What K1/K2 (gram.cu) and K4 (gram_wb.cu) share: the spec's flags and
// the Matern epilogue, so that both form an entry from d2 the same way.
#pragma once

#include <cuda_runtime.h>

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

struct Spec {
  int has_const;  // thetas[0] is log amp
  int has_white;  // thetas[off + n_ls] is log noise
  int n_ls;       // 1 (isotropic) or d lengthscales at thetas[off ..]
};

}  // namespace
