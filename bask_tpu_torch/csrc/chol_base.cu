// K3: batched Cholesky factor and its inverse of one diagonal block,
// float32, m <= 128, read in place.
//
// Replaces bask_tpu/ops/pallas_chol_base.py::chol_inv_base (steps in
// chol_inv_steps). For each matrix of the batch it runs the m
// right-looking steps of chol_inv_steps with the forward-substitution
// inverse interleaved:
//
//   d_j   = M[j][j],  inv_s = rsqrt(d_j)   (NaN on a non-PD pivot, by design)
//   col_r = M[r][j] * inv_s  (r >= j)      -> L[r][j]
//   x_c   = R[j][c] * inv_s  (c <= j)      -> L^-1[j][c]
//   M[r][c] -= col_r col_c   (r, c > j);   R[k][c] -= col_k x_c  (k > j, c <= j)
//
// with R starting as the identity. There is no clamp and no branch on the
// pivot: NaN from a non-PD block reaches L[m-1][m-1] and L^-1[m-1][m-1].
//
// What bounds it on an H100: the m dependent steps, not bytes. A
// (50, 128, 128) batch moves 8.2 MB (the lower triangle of A read, L and
// L^-1 written), 2.5 us at 3.35 TB/s, and its 70 MFLOP take 1 us at the
// float32 peak; 128 steps that each wait for the previous pivot take
// longer than either. The design keeps every step on chip and short:
//
// * one 256-thread block per matrix. Thread (tr, tc) of a 16 x 16 grid
//   owns the entries (tr + 16a, tc + 16b), a, b < 8, of the trailing
//   matrix M and of the residual R, in registers (64 + 64 floats).
//   A column of M and a row of R are never touched again after their
//   step, so they become L's column and L^-1's row in place.
// * a step publishes the pivot column of M and row j of R through
//   double-buffered shared memory (the 16 owners of each write it), then
//   one barrier, then every thread scales its rows' share of the column by
//   1/d_j and updates its entries with FP32 FMAs (no tensor cores, no
//   TF32). Column j of M and row j of R are left unscaled once their step
//   is done; the final store multiplies them by rsqrt(d_j), kept in shared
//   memory, so a step spends no instruction on them.
// * the loop over the 16-wide column blocks is unrolled, so the register
//   indices are static, and a block of entries that cannot change at this
//   step (above the diagonal, left of the pivot, above the pivot row) is
//   left out at compile time; only the pivot's own row and column blocks
//   are masked at run time.
// * the block reads the lower triangle of A where it lies (batch stride,
//   row stride), so a diagonal block of a larger factorization needs no
//   copy, and writes L and L^-1 to fresh contiguous outputs, upper
//   triangles 0.
//
// Measured on an H100 (PERF.md, scripts/kernel_variants.py): ~30 us per
// (50, 128, 128) launch, of which loading and storing take ~4 us and the
// bare step chain (publish, barrier, pivot rsqrt) ~14 us: ~200 cycles of
// latency per step, 128 times.

#include <cuda_runtime.h>

namespace {

constexpr int kG = 16;             // the thread grid is kG x kG
constexpr int kBlk = 8;            // entries per thread along each axis
constexpr int kMax = kG * kBlk;    // 128: the largest m
constexpr int kThreads = kG * kG;  // 256

// rsqrt.approx.ftz.f32: one MUFU operation (rsqrtf adds a rescale for
// subnormal pivots, which only a failed factorization has); NaN for a
// negative pivot, +inf for 0
__device__ __forceinline__ float rsqrt_mufu(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__global__ void __launch_bounds__(kThreads, 1)
chol_inv_kernel(const float* __restrict__ A, long long batch_stride,
                long long row_stride, float* __restrict__ L,
                float* __restrict__ Linv, int m) {
  __shared__ float colbuf[2][kMax];  // pivot column of M, unscaled
  __shared__ float rowbuf[2][kMax];  // row j of R, unscaled
  __shared__ float inv_diag[kMax];   // rsqrt of each pivot

  const int tc = threadIdx.x % kG;
  const int tr = threadIdx.x / kG;
  const float* a_in = A + (long long)blockIdx.x * batch_stride;

  float M[kBlk][kBlk];  // M[a][b] = M[tr + 16a][tc + 16b]
  float R[kBlk][kBlk];  // R[a][b] = R[tr + 16a][tc + 16b]
#pragma unroll
  for (int a = 0; a < kBlk; ++a) {
    const int r = tr + kG * a;
#pragma unroll
    for (int b = 0; b < kBlk; ++b) {
      const int c = tc + kG * b;
      // the lower triangle only: the upper one is never read
      M[a][b] = (r < m && c <= r) ? a_in[r * row_stride + c] : 0.0f;
      R[a][b] = (r == c) ? 1.0f : 0.0f;
    }
  }

#pragma unroll
  for (int jb = 0; jb < kBlk; ++jb) {  // column block of the pivot
    if (jb * kG >= m) continue;  // (no break: keeps the unrolled indices static)
#pragma unroll 1
    for (int jt = 0; jt < kG; ++jt) {
      const int j = jb * kG + jt;
      if (j >= m) break;
      float* col = colbuf[j & 1];
      float* row = rowbuf[j & 1];
      if (tc == jt) {  // owners of column j publish rows >= 16 jb
#pragma unroll
        for (int a = jb; a < kBlk; ++a) col[tr + kG * a] = M[a][jb];
      }
      if (tr == jt) {  // owners of row j of R publish columns < 16 (jb + 1)
#pragma unroll
        for (int b = 0; b <= jb; ++b) row[tc + kG * b] = R[jb][b];
      }
      __syncthreads();

      // one side scaled by 1/d_j = inv_s^2: col_r col_c = (M_rj / d_j) M_cj
      const float inv_s = rsqrt_mufu(col[j]);
      const float inv_d = inv_s * inv_s;
      if (threadIdx.x == 0) inv_diag[j] = inv_s;
      float cr[kBlk], cc[kBlk], xr[kBlk];
#pragma unroll
      for (int a = jb; a < kBlk; ++a) cr[a] = col[tr + kG * a] * inv_d;
#pragma unroll
      for (int b = jb; b < kBlk; ++b) cc[b] = col[tc + kG * b];
#pragma unroll
      for (int b = 0; b <= jb; ++b) xr[b] = row[tc + kG * b];

      // only rows below and columns right of the pivot change: column j
      // of M and row j of R keep their values, which scaled by inv_s are
      // column j of L and row j of L^-1. Blocks jb hold both sides of the
      // pivot, every later block lies past it.
      const float crm = tr > jt ? cr[jb] : 0.0f;
      const float ccm = tc > jt ? cc[jb] : 0.0f;
      const float xrm = tc <= jt ? xr[jb] : 0.0f;
#pragma unroll
      for (int a = jb; a < kBlk; ++a) {
        const float ca = a == jb ? crm : cr[a];
#pragma unroll
        for (int b = jb; b <= a; ++b) {  // b <= a: blocks holding lower entries
          const float cb = b == jb ? ccm : cc[b];
          M[a][b] = fmaf(-ca, cb, M[a][b]);
        }
#pragma unroll
        for (int b = 0; b <= jb; ++b) {
          const float xb = b == jb ? xrm : xr[b];
          R[a][b] = fmaf(-ca, xb, R[a][b]);
        }
      }
    }
  }
  __syncthreads();  // inv_diag complete

  float* l_out = L + (long long)blockIdx.x * m * m;
  float* x_out = Linv + (long long)blockIdx.x * m * m;
#pragma unroll
  for (int a = 0; a < kBlk; ++a) {
    const int r = tr + kG * a;
#pragma unroll
    for (int b = 0; b < kBlk; ++b) {
      const int c = tc + kG * b;
      if (r < m && c < m) {
        const bool lower = c <= r;
        l_out[r * m + c] = lower ? M[a][b] * inv_diag[c] : 0.0f;
        x_out[r * m + c] = lower ? R[a][b] * inv_diag[r] : 0.0f;
      }
    }
  }
}

}  // namespace

// A is read at A + i * batch_stride + r * row_stride + c (floats) for
// matrix i, row r >= column c; L and Linv are contiguous (batch, m, m).
extern "C" int bask_chol_inv_f32(const float* A, long long batch_stride,
                                 long long row_stride, float* L, float* Linv,
                                 int batch, int m, void* stream) {
  if (batch <= 0 || m < 1 || m > kMax || row_stride < m) {
    return (int)cudaErrorInvalidValue;
  }
  chol_inv_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
      A, batch_stride, row_stride, L, Linv, m);
  return (int)cudaGetLastError();
}
