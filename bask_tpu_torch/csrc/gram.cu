// K1 and K2: fused masked Matern/RBF gram for a batch of walkers, float32.
//
// K1 replaces bask_tpu/ops/pallas_gram.py::fused_masked_gram_batch (math in
// _tile_values, packing in _pack_params), K2 replaces
// ::fused_masked_gram_lower_batch. Both are the one templated kernel
// below; kLower selects K2.
//
// What bounds it on an H100: the output write. At the chain's shape
// (50, 512, 512) that is 52.4 MB, 15.7 us at 3.35 TB/s, against ~2d + 20
// instructions per entry (the d-long dot, a sqrt and an exp). The design:
//
// * Packing inside. Each block reads its walker's row of thetas and forms
//   amp = exp(theta_0), noise = exp(theta_white) and 1/ls_k = exp(-theta_ls)
//   itself with expf, from the spec's flags (has_const, has_white, n_ls of
//   1 or d), so the wrapper issues no device operation besides the launch.
// * One block computes a 64 x 128 tile of one walker's gram with 256
//   threads. Thread (lane, warp) owns rows warp + 8i (i < 8) and the 4
//   columns 4 lane .. 4 lane + 3: a register tile of 32 dot products, fed
//   per input dimension by one 16-byte shared-memory read of the columns
//   and two broadcast 16-byte reads of the rows.
// * The tile's 64 + 128 rows of X are staged with coalesced loads (the
//   rows of a tile are contiguous in X, so consecutive threads read
//   consecutive floats and none idles on d = 15), scaled by 1/ls on the
//   way into shared memory, in chunks of 16 input dimensions.
// * Each row's and each column's squared norm is computed once per tile,
//   into shared memory, by the FMA chain of the dot product: norm and dot
//   of a point with itself are then the same chain over the same floats
//   in the same order, so d2(i, i) = |xi|^2 + |xi|^2 - 2 xi.xi is exactly 0.
// * Each thread stores its 4 columns as one float4, so a warp writes 512
//   contiguous bytes of one row.
// * nu is a template argument, the root is one sqrt.approx, and a tile
//   off the diagonal and inside the real block skips the masks: the
//   epilogue of the 32 entries is straight-line code the compiler can
//   interleave (a run-time nu and IEEE sqrtf's slow-path call split it
//   into branches and took the kernel from 42 to 75 us on the H100).
//
// Measured on an H100 (PERF.md, scripts/kernel_variants.py): without
// its store the kernel is only ~1.3 us faster, without exp and sqrt
// ~7 us. The block's own latency (the X loads, the block's start) is
// ~4-9 % of its time at (256, 1024, 1024); the rest is the per-entry work
// at 80 registers. K4 (gram_wb.cu) computes the same function for shared X
// with the cross term on the tensor cores.
//
// X is addressed as X + b * x_walker_stride: stride 0 means shared X.
// FP32 FMAs only (no tensor cores, no TF32).
//
// K2 (kLower) keeps K1's values on and below the diagonal and writes
// exact zeros in every strictly upper 128 x 128 tile (col0 / 128 >
// row0 / 128). Such a block stages nothing and computes nothing; it only
// stores its zeros, as float4s, so the output write (what bounds both
// kernels) is the same as K1's. The blocks that compute run K1's exact
// instruction sequence, so their entries are bit-identical to K1's.

#include <cuda_runtime.h>

#include "gram_common.cuh"

namespace {

constexpr int kRows = 64;    // tile rows
constexpr int kCols = 128;   // tile columns: 32 lanes x 4
constexpr int kWarps = 8;    // 256 threads
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerThread = kRows / kWarps;  // 8
constexpr int kChunk = 16;   // input dimensions staged at once
// row strides of the staged chunks: multiples of 4 for 16-byte reads,
// offset from 32 banks so that the staging stores spread over banks
constexpr int kIStride = kRows + 4;
constexpr int kJStride = kCols + 4;
constexpr int kStageI = kRows * kChunk / kThreads;  // staged floats a thread
constexpr int kStageJ = kCols * kChunk / kThreads;  // loads per chunk

// rows of the tile are staged so that thread warp's 8 rows (warp + 8i)
// sit next to each other: row r at slot (r % 8) * 8 + r / 8
__device__ __forceinline__ int row_slot(int r) {
  return (r % kWarps) * kRowsPerThread + r / kWarps;
}

template <bool kLower, int kNu>
__global__ void __launch_bounds__(kThreads, 3)
gram_kernel(const float* __restrict__ thetas, long long theta_stride,
            Spec spec, const float* __restrict__ X,
            long long x_walker_stride, const float* __restrict__ alpha,
            int n_real, int n_pad, int d, float* __restrict__ out) {
  __shared__ __align__(16) float xi[kChunk][kIStride];
  __shared__ __align__(16) float xj[kChunk][kJStride];
  __shared__ __align__(16) float ni_s[kRows];  // by row slot
  __shared__ __align__(16) float nj_s[kCols];
  __shared__ float ils[kChunk];

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kCols;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col = col0 + 4 * lane;  // first of this thread's 4 columns
  const bool col_in = col < n_pad;  // n_pad % 64 == 0: all 4 or none

  float* ob = out + (long long)b * n_pad * n_pad;
  if (kLower && (col0 >> 7) > (row0 >> 7)) {  // a strictly upper 128-tile
    if (col_in) {
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int row = row0 + warp + kWarps * i;
        *reinterpret_cast<float4*>(ob + (long long)row * n_pad + col) = z;
      }
    }
    return;  // the whole block leaves: no barrier is skipped
  }

  const float* th = thetas + (long long)b * theta_stride;
  const int off = spec.has_const ? 1 : 0;
  const float amp = spec.has_const ? expf(th[0]) : 1.0f;
  const float noise = spec.has_white ? expf(th[off + spec.n_ls]) : 0.0f;
  const float* xb = X + (long long)b * x_walker_stride;

  float dot[kRowsPerThread][4];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) dot[i][q] = 0.0f;
  }
  float nrm = 0.0f;  // threads < 64: row tid's norm; < 192: column tid - 64

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    const int kc = min(kChunk, d - k0);
    // element e of a chunk is row e / kc, dimension e % kc; the quotient
    // by a float reciprocal is exact here (e < 2^11, kc <= 16). The loads
    // of X are issued before 1/ls is formed, so their latency overlaps
    // the load of thetas.
    const float inv_kc = 1.0f / kc;
    float si[kStageI], sj[kStageJ];  // raw X, scaled once 1/ls is known
#pragma unroll
    for (int u = 0; u < kStageI; ++u) {
      const int e = tid + u * kThreads;
      const int r = (int)((e + 0.5f) * inv_kc);
      si[u] = e < kRows * kc ? xb[(long long)(row0 + r) * d + k0 + e - r * kc] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kStageJ; ++u) {
      const int e = tid + u * kThreads;
      const int r = (int)((e + 0.5f) * inv_kc);
      sj[u] = e < kCols * kc && col0 + r < n_pad
                  ? xb[(long long)(col0 + r) * d + k0 + e - r * kc]
                  : 0.0f;
    }
    if (tid < kc) {
      ils[tid] = expf(-th[off + (spec.n_ls == 1 ? 0 : k0 + tid)]);
    }
    __syncthreads();  // ils ready; the previous chunk's reads are done
#pragma unroll
    for (int u = 0; u < kStageI; ++u) {
      const int e = tid + u * kThreads;
      const int r = (int)((e + 0.5f) * inv_kc);
      const int kk = e - r * kc;
      if (e < kRows * kc) xi[kk][row_slot(r)] = si[u] * ils[kk];
    }
#pragma unroll
    for (int u = 0; u < kStageJ; ++u) {
      const int e = tid + u * kThreads;
      const int r = (int)((e + 0.5f) * inv_kc);
      const int kk = e - r * kc;
      if (e < kCols * kc) xj[kk][r] = sj[u] * ils[kk];
    }
    __syncthreads();
    if (tid < kRows) {
      for (int kk = 0; kk < kc; ++kk) {
        const float v = xi[kk][row_slot(tid)];
        nrm = fmaf(v, v, nrm);
      }
    } else if (tid < kRows + kCols) {
      for (int kk = 0; kk < kc; ++kk) {
        const float v = xj[kk][tid - kRows];
        nrm = fmaf(v, v, nrm);
      }
    }
    for (int kk = 0; kk < kc; ++kk) {
      const float4 vj = *reinterpret_cast<const float4*>(&xj[kk][4 * lane]);
      const float4 va =
          *reinterpret_cast<const float4*>(&xi[kk][kRowsPerThread * warp]);
      const float4 vb =
          *reinterpret_cast<const float4*>(&xi[kk][kRowsPerThread * warp + 4]);
      const float vi[kRowsPerThread] = {va.x, va.y, va.z, va.w,
                                        vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        dot[i][0] = fmaf(vi[i], vj.x, dot[i][0]);
        dot[i][1] = fmaf(vi[i], vj.y, dot[i][1]);
        dot[i][2] = fmaf(vi[i], vj.z, dot[i][2]);
        dot[i][3] = fmaf(vi[i], vj.w, dot[i][3]);
      }
    }
  }
  if (tid < kRows) {
    ni_s[row_slot(tid)] = nrm;
  } else if (tid < kRows + kCols) {
    nj_s[tid - kRows] = nrm;
  }
  __syncthreads();

  if (!col_in) return;  // after the last barrier
  const float4 nj4 = *reinterpret_cast<const float4*>(&nj_s[4 * lane]);
  const float nj[4] = {nj4.x, nj4.y, nj4.z, nj4.w};
  // a tile off the diagonal and inside the real block needs no mask
  const bool plain_tile = row0 + kRows <= n_real && col0 + kCols <= n_real &&
                          (row0 + kRows <= col0 || col0 + kCols <= row0);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = row0 + warp + kWarps * i;
    const float ni = ni_s[kRowsPerThread * warp + i];
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float d2 = ni + nj[q] - 2.0f * dot[i][q];
      d2 = d2 < 0.0f ? 0.0f : d2;  // keeps NaN, like jnp.maximum
      v[q] = amp * matern<kNu>(d2);
    }
    if (!plain_tile) {
      const bool row_real = row < n_real;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = col + q;
        const bool real = row_real && c < n_real;
        v[q] = real ? v[q] : 0.0f;
        if (row == c) v[q] = real ? v[q] + noise + alpha[row] : 1.0f;
      }
    }
    *reinterpret_cast<float4*>(ob + (long long)row * n_pad + col) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <bool kLower>
auto gram_kernel_for(int nu_code) {
  return nu_code == 0   ? gram_kernel<kLower, 0>
         : nu_code == 1 ? gram_kernel<kLower, 1>
         : nu_code == 2 ? gram_kernel<kLower, 2>
                        : gram_kernel<kLower, 3>;
}

template <bool kLower>
int launch_gram(const float* thetas, long long theta_stride, int has_const,
                int has_white, int n_ls, const float* X,
                long long x_walker_stride, const float* alpha, int n_real,
                int B, int n_pad, int d, int nu_code, float* out,
                void* stream) {
  const int multiple = kLower ? 2 * kRows : kRows;
  if (B <= 0 || B > 65535 || n_pad <= 0 || n_pad % multiple || d <= 0 ||
      nu_code < 0 || nu_code > 3 || !(n_ls == 1 || n_ls == d)) {
    return (int)cudaErrorInvalidValue;
  }
  const Spec spec{has_const, has_white, n_ls};
  const dim3 grid((n_pad + kCols - 1) / kCols, n_pad / kRows, B);
  const auto kernel = gram_kernel_for<kLower>(nu_code);
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      thetas, theta_stride, spec, X, x_walker_stride, alpha, n_real, n_pad,
      d, out);
  return (int)cudaGetLastError();
}

}  // namespace

// K1: n_pad must be a multiple of 64; thetas rows theta_stride floats apart.
extern "C" int bask_gram_f32(const float* thetas, long long theta_stride,
                             int has_const, int has_white, int n_ls,
                             const float* X, long long x_walker_stride,
                             const float* alpha, int n_real, int B, int n_pad,
                             int d, int nu_code, float* out, void* stream) {
  return launch_gram<false>(thetas, theta_stride, has_const, has_white, n_ls,
                            X, x_walker_stride, alpha, n_real, B, n_pad, d,
                            nu_code, out, stream);
}

// K2: the same arguments; n_pad must be a multiple of 128.
extern "C" int bask_gram_lower_f32(const float* thetas, long long theta_stride,
                                   int has_const, int has_white, int n_ls,
                                   const float* X, long long x_walker_stride,
                                   const float* alpha, int n_real, int B,
                                   int n_pad, int d, int nu_code, float* out,
                                   void* stream) {
  return launch_gram<true>(thetas, theta_stride, has_const, has_white, n_ls,
                           X, x_walker_stride, alpha, n_real, B, n_pad, d,
                           nu_code, out, stream);
}

// Resident blocks per SM on the current device of K1 (kernel 0) or K2 (1)
// for nu_code, from the occupancy calculator: what the built kernel's
// registers and shared memory allow (d does not change them). K4's plan,
// blocks per SM included, comes from bask_gram_wb_info (gram_wb.cu).
extern "C" int bask_gram_blocks_per_sm(int kernel, int nu_code, int d,
                                       int* blocks) {
  if (kernel < 0 || kernel > 1 || nu_code < 0 || nu_code > 3 || d <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel == 0 ? gram_kernel_for<false>(nu_code) : gram_kernel_for<true>(nu_code),
      kThreads, 0);
}

extern "C" const char* bask_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
