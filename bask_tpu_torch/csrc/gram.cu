// K1 and K2: fused masked Matern/RBF gram for a batch of walkers, float32.
//
// K1 replaces bask_tpu/ops/pallas_gram.py::fused_masked_gram_batch (math in
// _tile_values), K2 replaces ::fused_masked_gram_lower_batch. Both are
// the one templated kernel below; kLower selects K2. One block computes
// one 64 x 64 tile of one walker's (n_pad, n_pad) gram. The tile's 64
// query rows and 64 column rows of X, each scaled by the walker's
// 1/lengthscale, are staged in shared memory in 32-wide chunks of the
// input dimension, so any d works. Thread
// (tx, ty) owns column tx and rows ty, ty+4, ..., ty+60; it accumulates
// the dot products and both squared norms with FP32 FMAs (no TF32), then
// writes d2 = |xi|^2 + |xj|^2 - 2 xi.xj (clamped at 0), the Matern value
// and the mask in one pass. Per output row, the 64 threads of a tile row
// store 256 contiguous bytes: the output write is what bounds this kernel.
//
// Packed parameters per walker: [amp, noise, 1/ls_0 .. 1/ls_{d-1}].
// X is addressed as X + b * x_walker_stride: stride 0 means shared X.
//
// K2 (kLower) keeps K1's values on and below the diagonal and writes
// exact zeros in every strictly upper 128 x 128 tile: in the 64-tile grid
// that is block (by, bx) with bx / 2 > by / 2. Such a block stages
// nothing and computes nothing; it only stores its zeros, so the output
// write (what bounds both kernels) is the same as K1's, while the
// staging, FMAs and expf shrink to the lower 128-tiles (10 of 16 at
// n_pad = 512). The blocks that compute run K1's exact instruction
// sequence, so their entries are bit-identical to K1's.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kChunk = 32;
constexpr int kThreadRows = 4;
constexpr int kRowsPerThread = kTile / kThreadRows;

__device__ __forceinline__ float matern(float d2, int nu_code) {
  if (nu_code == 3) return expf(-0.5f * d2);  // RBF
  const float r = sqrtf(d2 + 1e-36f);
  if (nu_code == 0) return expf(-r);
  if (nu_code == 1) {
    const float s = 1.7320508075688772f * r;
    return (1.0f + s) * expf(-s);
  }
  const float s = 2.23606797749979f * r;
  return (1.0f + s + s * s / 3.0f) * expf(-s);
}

template <bool kLower>
__global__ void __launch_bounds__(kTile * kThreadRows)
gram_kernel(const float* __restrict__ packed, const float* __restrict__ X,
            long long x_walker_stride, const float* __restrict__ alpha,
            int n_real, int n_pad, int d, int nu_code,
            float* __restrict__ out) {
  __shared__ float xi[kTile][kChunk + 1];
  __shared__ float xj[kTile][kChunk + 1];

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTile + tx;

  float* ob = out + (long long)b * n_pad * n_pad;
  if (kLower && (blockIdx.x >> 1) > (blockIdx.y >> 1)) {
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      ob[(long long)(row0 + ty + kThreadRows * r) * n_pad + col0 + tx] = 0.0f;
    }
    return;  // the whole block leaves: no barrier is skipped
  }

  const float* p = packed + (long long)b * (d + 2);
  const float amp = p[0];
  const float noise = p[1];
  const float* xb = X + (long long)b * x_walker_stride;

  float dot[kRowsPerThread];
  float ni[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    dot[r] = 0.0f;
    ni[r] = 0.0f;
  }
  float nj = 0.0f;

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    const int kc = min(kChunk, d - k0);
    for (int e = tid; e < kTile * kChunk; e += kTile * kThreadRows) {
      const int rr = e / kChunk;
      const int kk = e % kChunk;
      float vi = 0.0f, vj = 0.0f;
      if (kk < kc) {
        const float il = p[2 + k0 + kk];
        vi = xb[(long long)(row0 + rr) * d + k0 + kk] * il;
        vj = xb[(long long)(col0 + rr) * d + k0 + kk] * il;
      }
      xi[rr][kk] = vi;
      xj[rr][kk] = vj;
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      const float vj = xj[tx][kk];
      nj = fmaf(vj, vj, nj);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float vi = xi[ty + kThreadRows * r][kk];
        dot[r] = fmaf(vi, vj, dot[r]);
        ni[r] = fmaf(vi, vi, ni[r]);
      }
    }
    __syncthreads();
  }

  const int col = col0 + tx;
  const bool col_real = col < n_real;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = row0 + ty + kThreadRows * r;
    float d2 = ni[r] + nj - 2.0f * dot[r];
    d2 = d2 < 0.0f ? 0.0f : d2;  // keeps NaN, like jnp.maximum
    const bool real = (row < n_real) && col_real;
    float v = real ? amp * matern(d2, nu_code) : 0.0f;
    if (row == col) v = real ? v + noise + alpha[row] : 1.0f;
    ob[(long long)row * n_pad + col] = v;
  }
}

template <bool kLower>
int launch_gram(const float* packed, const float* X, long long x_walker_stride,
                const float* alpha, int n_real, int B, int n_pad, int d,
                int nu_code, float* out, void* stream) {
  const int multiple = kLower ? 2 * kTile : kTile;
  if (B <= 0 || B > 65535 || n_pad <= 0 || n_pad % multiple || d <= 0 ||
      nu_code < 0 || nu_code > 3) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(n_pad / kTile, n_pad / kTile, B);
  const dim3 block(kTile, kThreadRows);
  gram_kernel<kLower><<<grid, block, 0, (cudaStream_t)stream>>>(
      packed, X, x_walker_stride, alpha, n_real, n_pad, d, nu_code, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bask_gram_f32(const float* packed, const float* X,
                             long long x_walker_stride, const float* alpha,
                             int n_real, int B, int n_pad, int d, int nu_code,
                             float* out, void* stream) {
  return launch_gram<false>(packed, X, x_walker_stride, alpha, n_real, B,
                            n_pad, d, nu_code, out, stream);
}

// K2: n_pad must be a multiple of 128.
extern "C" int bask_gram_lower_f32(const float* packed, const float* X,
                                   long long x_walker_stride,
                                   const float* alpha, int n_real, int B,
                                   int n_pad, int d, int nu_code, float* out,
                                   void* stream) {
  return launch_gram<true>(packed, X, x_walker_stride, alpha, n_real, B,
                           n_pad, d, nu_code, out, stream);
}

extern "C" const char* bask_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
