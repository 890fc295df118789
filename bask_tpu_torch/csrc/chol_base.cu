// K3: batched base-case Cholesky factor and its inverse, float32, m <= 32.
//
// Replaces bask_tpu/ops/pallas_chol_base.py::chol_inv_base (steps in
// chol_inv_steps). One warp factors one matrix; a block holds four.
// Lane r keeps row r of the trailing matrix M and column r of the running
// residual R (R starts as the identity) in registers. Step j:
//
//   d_j    = M[j][j]                      (shuffle from lane j)
//   inv_s  = rsqrt(d_j)                   (NaN on a non-PD pivot, by design)
//   col_r  = r >= j ? M[r][j] * inv_s : 0 -> L[r][j]
//   xrow_c = R[j][c] * inv_s              -> L^-1[j][c]
//   M[r][c] -= col_r col_c;  R[k][c] -= col_k xrow_c for k > j
//
// exactly the right-looking order of chol_inv_steps, with the
// forward-substitution inverse interleaved. There is no clamp and no
// branch on the pivot: NaN from a non-PD block reaches L[m-1][m-1] and
// L^-1[m-1][m-1]. The m steps are dependent, so latency, not bytes (a
// (50, 32, 32) batch is 200 KB), bounds this kernel; keeping each
// matrix in one warp's registers makes every step a handful of shuffles
// and FMAs with no shared memory and no block-level barrier.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMax = 32;

__global__ void __launch_bounds__(kWarps * 32)
chol_inv_kernel(const float* __restrict__ A, float* __restrict__ L,
                float* __restrict__ Linv, int batch, int m) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= batch) return;  // whole warp leaves together
  const long long base = (long long)b * m * m;
  const bool valid = lane < m;

  float M[kMax];  // M[c] = M[lane][c]
  float R[kMax];  // R[k] = R[k][lane]
#pragma unroll
  for (int c = 0; c < kMax; ++c) {
    M[c] = (valid && c < m) ? A[base + (long long)lane * m + c] : 0.0f;
    R[c] = (c == lane) ? 1.0f : 0.0f;
  }

#pragma unroll
  for (int j = 0; j < kMax; ++j) {
    if (j < m) {
      const float dj = __shfl_sync(full, M[j], j);
      const float inv_s = rsqrtf(dj);
      const float col = (valid && lane >= j) ? M[j] * inv_s : 0.0f;
      const float xrow = R[j] * inv_s;
      if (valid) {
        L[base + (long long)lane * m + j] = col;
        Linv[base + (long long)j * m + lane] = xrow;
      }
      if (j + 1 < m) {
#pragma unroll
        for (int k = 0; k < kMax; ++k) {
          const float colk = __shfl_sync(full, col, k);
          M[k] -= col * colk;
          if (k > j) R[k] -= colk * xrow;
        }
      }
    }
  }
}

}  // namespace

extern "C" int bask_chol_inv_f32(const float* A, float* L, float* Linv,
                                 int batch, int m, void* stream) {
  if (batch <= 0 || m < 1 || m > kMax) return (int)cudaErrorInvalidValue;
  const int blocks = (batch + kWarps - 1) / kWarps;
  chol_inv_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      A, L, Linv, batch, m);
  return (int)cudaGetLastError();
}
